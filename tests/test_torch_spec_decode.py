"""Speculative decoding in the port (serving/scheduler.py: propose and
verify) on the CPU.

The contract: with a draft model the scheduler's output equals plain
decoding bit for bit whatever the draft proposes (every verified step is
the pool step's update on the pool's own rows), also with the prefix cache
on, fp or int8. Against the JAX package's speculative scheduler on the same
JAX-saved target and draft and the same requests: ids and lengths equal,
scores within SCORE_TOL, and the same rounds, proposals and accepted tokens.
Plus the draft's validation errors, the `draft_model` sidecar written by
either package, and the speculative block of stats() and /metrics.

Artifacts are built once per module; requests are submitted one at a time,
so each one's rounds do not depend on thread timing.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import serving as jserving
from paddle_tpu_torch.serving import BucketPolicy, ContinuousScheduler, ServingEngine

V, E, H = 12, 8, 16
K, T = 3, 6
SCORE_TOL = 1e-5
WAIT_MS = 60000


@pytest.fixture(autouse=True)
def one_thread():
    """Many small eager ops: one thread is faster on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen_program(pkg, bos=0, eos=1, feed="h0"):
    """tests/test_torch_gen_serving.py's tiny decoder with its bos, eos and
    feed name as arguments."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        h0 = pkg.layers.data(feed, shape=[-1, H], append_batch_size=False)
        gen = pkg.layers.BeamSearchDecoder(beam_size=K, max_len=T, bos_id=bos, eos_id=eos)
        with gen.step():
            prev = gen.prev_ids()
            h_prev = gen.memory(init=h0)
            emb = pkg.layers.embedding(prev, size=[V, E], param_attr="g_emb")
            h = pkg.layers.fc(pkg.layers.concat([emb, h_prev], axis=1), size=H, act="tanh",
                              param_attr="g_w", bias_attr=pkg.ParamAttr(name="g_b"))
            gen.update_memory(h_prev, h)
            gen.output_logits(pkg.layers.fc(h, size=V, param_attr="g_wo",
                                            bias_attr=pkg.ParamAttr(name="g_bo")))
        outs = gen()
    return main, startup, outs


def _jax_dir(d, seed, draft_model=None, **kw):
    pt.reset()
    main, startup, outs = _gen_program(pt, **kw)
    startup.random_seed = seed
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    pt.io.save_inference_model(d, [kw.get("feed", "h0")], list(outs), main_program=main,
                               scope=scope, draft_model=draft_model)
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """target: the JAX-saved target; draft: a smaller-seeded twin saved as
    the target's `draft` sidecar dir; self: the target as its own draft;
    adversarial: the draft with its output bias forcing one token."""
    root = tmp_path_factory.mktemp("spec")
    target = _jax_dir(str(root / "target"), seed=3, draft_model="draft")
    draft = _jax_dir(str(root / "target" / "draft"), seed=5)
    adv = str(root / "adversarial")
    shutil.copytree(draft, adv)
    params = dict(np.load(os.path.join(adv, "params.npz")))
    bias = np.full_like(params["g_bo"], -50.0)
    bias[7] = 50.0  # always proposes token 7
    params["g_bo"] = bias
    np.savez(os.path.join(adv, "params.npz"), **params)
    return {"target": target, "draft": draft, "self": target, "adversarial": adv,
            "root": str(root)}


def _engine(d, name):
    return ServingEngine(d, policy=BucketPolicy(max_batch_size=8), model_name=name,
                         device="cpu")


def _feeds(seed=0, repeat=True):
    rng = np.random.RandomState(seed)
    feeds = [{"h0": rng.randn(n, H).astype(np.float32)} for n in (1, 3, 2)]
    # the first feed again: a prefix-cache hit when the cache is on
    return feeds + [feeds[0]] if repeat else feeds


def _run(d, name, feeds, **kw):
    sched = ContinuousScheduler(_engine(d, name), max_slots=4, **kw).start()
    try:
        outs = [sched.generate(f, timeout_ms=WAIT_MS) for f in feeds]
        return outs, sched.stats(), sched.syncs_total
    finally:
        sched.stop()


def _plain_kw(cache):
    return ({} if cache == "none" else
            {"prefix_cache_mb": 1.0, "prefix_cache_quant": "int8" if cache == "int8" else None})


@pytest.mark.parametrize("cache", ["none", "fp", "int8"])
@pytest.mark.parametrize("which", ["self", "adversarial"])
def test_draft_equals_plain_bit_for_bit(dirs, which, cache):
    """Whatever the draft proposes (the target itself, or one token
    always), the outputs are plain decoding's bits; the cache's hits admit
    the draft's state too."""
    feeds = _feeds()
    kw = _plain_kw(cache)
    want = _run_plain(dirs, which, cache, feeds, kw)
    got, st, syncs = _run(dirs["target"], f"spec_{which}_{cache}", feeds,
                          draft_model=dirs[which], draft_k=3, **kw)
    for g, w in zip(got, want):
        for k in ("ids", "scores", "lengths"):
            np.testing.assert_array_equal(g[k], w[k])
    spec = st["speculative"]
    # one host sync a round
    assert syncs == spec["verify_rounds_total"] > 0
    assert spec["accepted_total"] == st["tokens_total"]
    # the target drafting for itself moves more tokens a proposal than a
    # draft that always proposes token 7
    assert spec["accept_rate"] > 0.5 if which == "self" else spec["accept_rate"] < 0.5
    if cache != "none":
        assert st["prefix_cache"]["hits"] >= 1


def _run_plain(dirs, which, cache, feeds, kw):
    """The same requests without a draft (an engine of its own)."""
    eng = _engine(dirs["target"], f"plain_{which}_{cache}")
    eng.draft_meta = None  # the target carries a draft sidecar: ignore it
    sched = ContinuousScheduler(eng, max_slots=4, **kw).start()
    try:
        return [sched.generate(f, timeout_ms=WAIT_MS) for f in feeds]
    finally:
        sched.stop()


def test_matches_the_jax_speculative_scheduler(dirs):
    """The same JAX-saved target, draft and requests through both packages'
    speculative schedulers."""
    feeds = _feeds(seed=1, repeat=False)
    jeng = jserving.ServingEngine(dirs["target"],
                                  policy=jserving.BucketPolicy(max_batch_size=8),
                                  model_name="spec_jax")
    jsched = jserving.ContinuousScheduler(jeng, max_slots=4, draft_model=dirs["draft"],
                                          draft_k=3).start()
    try:
        want = [jsched.generate(f, timeout_ms=120000) for f in feeds]
        jst = jsched.stats()["speculative"]
    finally:
        jsched.stop()
    got, st, _ = _run(dirs["target"], "spec_port", feeds, draft_model=dirs["draft"], draft_k=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ids"], np.asarray(w["ids"]))
        np.testing.assert_array_equal(g["lengths"], np.asarray(w["lengths"]))
        np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]), rtol=0, atol=SCORE_TOL)
    spec = st["speculative"]
    for k in ("verify_rounds_total", "proposed_total", "accepted_total"):
        assert spec[k] == jst[k], k


def test_jax_draft_sidecar_auto_applies(dirs):
    """The JAX exporter's `draft_model` sidecar (a path relative to the
    artifact) gives the port's scheduler its draft, with no argument."""
    eng = _engine(dirs["target"], "sidecar")
    assert eng.draft_meta == {"dir": "draft"}
    sched = ContinuousScheduler(eng, max_slots=4)
    assert sched._draft is not None
    assert sched._draft.dir == os.path.join(dirs["target"], "draft")
    assert sched.stats()["speculative"]["draft_k"] == 4


def test_port_writes_the_draft_sidecar(dirs, tmp_path):
    """ptt.io.save_inference_model(draft_model=) writes the JAX exporter's
    sidecar, which both packages read."""
    ptt.reset_default_programs()
    main, startup, outs = _gen_program(ptt)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    d = str(tmp_path / "port_target")
    ptt.io.save_inference_model(d, ["h0"], list(outs), main_program=main, scope=scope,
                                draft_model="draft")
    meta = json.load(open(os.path.join(d, "meta.json")))
    jmeta = json.load(open(os.path.join(dirs["target"], "meta.json")))
    assert meta["draft_model"] == jmeta["draft_model"] == {"dir": "draft"}
    prog, _, _ = pt.io.load_inference_model(d, scope=pt.Scope())
    assert prog._draft_meta == {"dir": "draft"}


def _bad_draft(root, kind):
    d = os.path.join(root, f"bad_{kind}")
    if os.path.isdir(d):
        return d
    if kind == "dense":
        ptt.reset_default_programs()
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            pred = ptt.layers.fc(ptt.layers.data("h0", shape=[H]), size=2)
        scope = ptt.Scope()
        ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
        ptt.io.save_inference_model(d, ["h0"], [pred], main_program=main, scope=scope)
        return d
    kw = {"bos": {"bos": 2}, "feeds": {"feed": "h1"}}[kind]
    return _jax_dir(d, seed=5, **kw)


@pytest.mark.parametrize("kind,match", [
    ("dense", "no beam_search_group op"),
    ("bos", "bos/eos"),
    ("feeds", "draft model feeds"),
    ("draft_k", "draft_k must be >= 1"),
])
def test_draft_validation_errors(dirs, kind, match):
    """Each package refuses the same drafts with the same messages."""
    eng = _engine(dirs["target"], f"bad_{kind}")
    jeng = jserving.ServingEngine(dirs["target"], policy=jserving.BucketPolicy(max_batch_size=8),
                                  model_name=f"jbad_{kind}")
    if kind == "draft_k":
        args = {"draft_model": dirs["draft"], "draft_k": 0}
    else:
        args = {"draft_model": _bad_draft(dirs["root"], kind)}
    with pytest.raises(ValueError, match=match) as got:
        ContinuousScheduler(eng, **args)
    with pytest.raises(ValueError, match=match) as want:
        jserving.ContinuousScheduler(jeng, **args)
    # the same message, up to the JAX package's dash or the port's colon
    assert re.split("[:—]", str(got.value))[0].strip() == \
        re.split("[:—]", str(want.value))[0].strip()


def test_speculative_stats_and_metrics(dirs):
    """stats()["speculative"] and the registry's speculative families; on
    the CPU every round runs eagerly (no capture)."""
    from paddle_tpu_torch.obs import promparse

    eng = _engine(dirs["target"], "spec_metrics")
    sched = eng.scheduler(max_slots=4, draft_model=dirs["draft"], draft_k=2)
    try:
        out = eng.generate(_feeds(seed=2)[0], timeout_ms=WAIT_MS)
        assert out["ids"].shape == (1, K, T)
        st = sched.stats()["speculative"]
    finally:
        sched.stop()
    assert st["draft_k"] == 2 and st["verify_rounds_total"] >= 1
    assert st["proposed_total"] == 2 * st["verify_rounds_total"]
    for step in ("propose_step", "verify_step"):
        assert st[step]["eager_steps"] == st["verify_rounds_total"]
        assert st[step]["captures"] == 0
    fams = promparse.parse_text(eng.metrics.render())
    for name in ("gen_verify_rounds_total", "gen_draft_tokens_total",
                 "gen_draft_accepted_total", "gen_accept_rate"):
        assert "ptserving_" + name in fams, name
    assert "ptserving_gen_verify_round_seconds" in fams
