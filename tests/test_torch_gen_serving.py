"""Continuous batching in the port (serving/scheduler.py) on the CPU.

The contract: a scheduler admits queued generation requests into a fixed
pool of decode slots, steps the whole pool at once, retires finished beams
early and streams tokens, and each request's result equals the batch-mode
`beam_search_group` decode's bit for bit (the pool step and the batch op
share `beam_step`, and the pool and the batch bucket run the same S·K rows).
Against the JAX package's ContinuousScheduler on the same artifact and
requests: ids and lengths equal, scores within SCORE_TOL (the two packages'
log-softmax and GEMMs round differently, a few f32 ulps over T=6 steps).
Plus the shed, deadline, fault and breaker contract, the generation sidecar
both ways, the prefix cache, and HTTP /generate.

Every artifact is built once per module; every wait has a timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import serving as jserving
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (BucketPolicy, CircuitBreaker, CircuitOpenError,
                                      ContinuousScheduler, DeadlineError, GenerationAborted,
                                      ModelRegistry, PrefixCache, ServingEngine, ShedError,
                                      make_server, prefix_row_key)

V, E, H = 12, 8, 16
BOS, EOS = 0, 1
K, T = 3, 6
CH_V, CH_T, CH_K = 20, 12, 2
_CH_BONUS, _CH_BETA = 10.0, 1.0
SCORE_TOL = 1e-5
WAIT = 60  # seconds, every wait's bound


def _gen_program(pkg, length_normalize=False):
    """tests/test_gen_serving.py's tiny GRU-ish decoder through `pkg`'s
    front end: (main, startup, outputs)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        h0 = pkg.layers.data("h0", shape=[-1, H], append_batch_size=False)
        gen = pkg.layers.BeamSearchDecoder(beam_size=K, max_len=T, bos_id=BOS, eos_id=EOS,
                                           length_normalize=length_normalize)
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


def _jax_gen_dir(d, length_normalize=False):
    pt.reset()
    main, startup, outs = _gen_program(pt, length_normalize)
    startup.random_seed = 3
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    pt.io.save_inference_model(d, ["h0"], list(outs), main_program=main, scope=scope)


def _chain_weights():
    w = np.full((CH_V + 1, CH_V), -30.0, np.float32)
    w[:, BOS] = -60.0
    for v in range(2, CH_V - 1):
        for j in range(CH_K):
            w[v, min(v + 1 + j, CH_V - 1)] = _CH_BONUS - j
        w[v, EOS] = _CH_BETA * v
    for j in range(CH_K):
        w[BOS, 2 + j] = _CH_BONUS - j
    w[CH_V - 1, EOS] = _CH_BONUS + 5.0
    w[CH_V, :] = 0.0
    w[CH_V, EOS] = -_CH_BETA
    return {"c_emb": np.eye(CH_V, dtype=np.float32), "c_ctl": w}


def _chain_thr(length: int) -> np.ndarray:
    return np.array([[length - (_CH_BONUS / _CH_BETA + 1.0)]], np.float32)


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tgen"))
    _jax_gen_dir(d)
    return d


@pytest.fixture(scope="module")
def gen_ln_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tgen_ln"))
    _jax_gen_dir(d, length_normalize=True)
    return d


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    """The bench's controlled-length token chain (decode length about
    thr + 11), built and saved by the port."""
    d = str(tmp_path_factory.mktemp("tgen_chain"))
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        thr = ptt.layers.data("thr", shape=[-1, 1], append_batch_size=False)
        gen = ptt.layers.BeamSearchDecoder(beam_size=CH_K, max_len=CH_T, bos_id=BOS,
                                           eos_id=EOS)
        with gen.step():
            prev = gen.prev_ids()
            thr_m = gen.memory(init=thr)
            emb = ptt.layers.embedding(prev, size=[CH_V, CH_V], param_attr="c_emb")
            logits = ptt.layers.fc(ptt.layers.concat([emb, thr_m], axis=1), size=CH_V,
                                   param_attr="c_ctl", bias_attr=False)
            gen.update_memory(thr_m, thr_m)
            gen.output_logits(logits)
        outs = gen()
    scope = ptt.Scope()
    ptt.io.params_from_numpy(scope, _chain_weights(), "cpu")
    ptt.io.save_inference_model(d, ["thr"], list(outs), main_program=main, scope=scope)
    return d


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tgen_dense"))
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        pred = ptt.layers.fc(ptt.layers.data("x", shape=[4]), size=2)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    ptt.io.save_inference_model(d, ["x"], [pred], main_program=main, scope=scope)
    return d


def _engine(d, name, max_batch_size=8):
    return ServingEngine(d, policy=BucketPolicy(max_batch_size=max_batch_size),
                         model_name=name, device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(got["ids"], want[0])
    np.testing.assert_array_equal(got["scores"], want[1])
    np.testing.assert_array_equal(got["lengths"], want[2])


# ------------------------------------------------- continuous vs batch ------


@pytest.mark.parametrize("ln", [False, True], ids=["plain", "length_normalize"])
def test_continuous_equals_batch_mode_bit_for_bit(gen_dir, gen_ln_dir, ln):
    eng = _engine(gen_ln_dir if ln else gen_dir, f"bits_{ln}")
    sched = eng.scheduler(max_slots=4)
    rng = np.random.RandomState(0)
    try:
        for n in ((3,) if ln else (1, 2, 3, 5)):
            feed = {"h0": rng.randn(n, H).astype(np.float32)}
            _same(eng.generate(feed, timeout_ms=60000), eng.predict(feed))
    finally:
        sched.stop()


def test_continuous_matches_the_jax_scheduler(gen_dir):
    """The same JAX-saved artifact and requests through both packages'
    continuous schedulers."""
    rng = np.random.RandomState(1)
    feeds = [{"h0": rng.randn(n, H).astype(np.float32)} for n in (1, 3, 2)]
    jeng = jserving.ServingEngine(gen_dir, policy=jserving.BucketPolicy(max_batch_size=8),
                                  model_name="tgen_jax")
    jsched = jeng.scheduler(max_slots=4)
    try:
        want = [jsched.generate(f, timeout_ms=120000) for f in feeds]
    finally:
        jsched.stop()
    eng = _engine(gen_dir, "tgen_port")
    sched = eng.scheduler(max_slots=4)
    try:
        got = [sched.generate(f, timeout_ms=60000) for f in feeds]
    finally:
        sched.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ids"], np.asarray(w["ids"]))
        np.testing.assert_array_equal(g["lengths"], np.asarray(w["lengths"]))
        np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]), rtol=0, atol=SCORE_TOL)


def test_admission_never_exceeds_max_slots(gen_dir):
    eng = _engine(gen_dir, "slots")
    sched = ContinuousScheduler(eng, max_slots=2, max_queue=16)
    occupied = []
    orig = sched._step_once

    def spying_step():
        occupied.append(int(sched._active.sum()))
        orig()

    sched._step_once = spying_step
    rng = np.random.RandomState(2)
    feeds = [{"h0": rng.randn(1, H).astype(np.float32)} for _ in range(7)]
    handles = [sched.submit(f, timeout_ms=60000) for f in feeds]
    sched.start()
    try:
        outs = [h.result(timeout=WAIT) for h in handles]
    finally:
        sched.stop()
    assert occupied and max(occupied) <= 2, occupied
    assert sched.admitted_total == sched.retired_total == 7
    assert sched.syncs_total == sched.steps_total  # one readback a step
    for f, o in zip(feeds, outs):
        _same(o, eng.predict(f))


def test_ragged_finish_order(chain_dir):
    """A short request submitted after a long one finishes first, and both
    still equal batch mode."""
    eng = _engine(chain_dir, "ragged")
    sched = eng.scheduler(max_slots=2)
    done_order = []
    try:
        long_h = sched.submit({"thr": _chain_thr(11)}, timeout_ms=60000)
        short_h = sched.submit({"thr": _chain_thr(4)}, timeout_ms=60000)

        def wait(tag, h):
            h.result(timeout=WAIT)
            done_order.append(tag)

        ts = [threading.Thread(target=wait, args=a) for a in (("long", long_h),
                                                               ("short", short_h))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in ts)
        assert done_order[0] == "short", done_order
        for thr, h in ((11, long_h), (4, short_h)):
            _same(h.result(timeout=1), eng.predict({"thr": _chain_thr(thr)}))
        assert int(eng.predict({"thr": _chain_thr(4)})[2][0, 0]) < \
            int(eng.predict({"thr": _chain_thr(11)})[2][0, 0])
    finally:
        sched.stop()


def test_streaming_token_events(gen_dir):
    eng = _engine(gen_dir, "stream")
    sched = eng.scheduler(max_slots=2)
    try:
        feed = {"h0": np.random.RandomState(3).randn(1, H).astype(np.float32)}
        events = list(sched.submit(feed, timeout_ms=60000).events(timeout=WAIT))
        kinds = [e["event"] for e in events]
        assert kinds[-1] == "done" and set(kinds[:-1]) == {"token"}
        toks = [e for e in events if e["event"] == "token"]
        assert [e["step"] for e in toks] == list(range(len(toks)))
        assert all(e["row"] == 0 for e in toks)
        want = eng.predict(feed)
        np.testing.assert_array_equal(events[-1]["outputs"]["ids"], want[0])
    finally:
        sched.stop()


# ----------------------------------------------- deadlines, shed, faults ----


def test_queue_full_sheds(gen_dir):
    sched = ContinuousScheduler(_engine(gen_dir, "shed_gen"), max_slots=1, max_queue=2)
    f = {"h0": np.zeros((1, H), np.float32)}
    sched.submit(f)
    sched.submit(f)
    with pytest.raises(ShedError, match="queue full"):
        sched.submit(f)
    assert sched.metrics.counter_value("gen_shed_total") >= 1
    sched.stop()


def test_deadline_exceeded_while_queued(gen_dir):
    sched = ContinuousScheduler(_engine(gen_dir, "dl_gen"), max_slots=1, max_queue=4)
    h = sched.submit({"h0": np.zeros((1, H), np.float32)}, timeout_ms=10)
    time.sleep(0.05)
    sched.start()
    try:
        with pytest.raises(DeadlineError):
            h.result(timeout=WAIT)
        assert sched.metrics.counter_value("gen_deadline_exceeded_total") >= 1
    finally:
        sched.stop()


def test_deadline_rechecked_after_slot_admission(gen_dir):
    """Admission that eats the budget fails the request before its first
    token, frees its slots, and the pool then serves fresh traffic."""
    sched = ContinuousScheduler(_engine(gen_dir, "dl_admit"), max_slots=2, max_queue=4)
    orig = sched._run_prefix

    def slow_prefix(req):
        orig(req)
        time.sleep(0.08)  # outlives the deadline after the queue's check

    sched._run_prefix = slow_prefix
    h = sched.submit({"h0": np.zeros((1, H), np.float32)}, timeout_ms=60)
    sched.start()
    try:
        with pytest.raises(DeadlineError):
            h.result(timeout=WAIT)
        ev = next(h.events(timeout=1))
        assert ev["event"] == "error" and ev["kind"] == "DeadlineError"
        deadline = time.monotonic() + 10
        while sched._active.any() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not sched._active.any() and not bool(sched._active_dev.any())
        sched._run_prefix = orig
        out = sched.generate({"h0": np.zeros((1, H), np.float32)}, timeout_ms=60000)
        assert out["ids"].shape == (1, K, T)
    finally:
        sched.stop()


def test_fault_mid_pool_aborts_inflight_and_recovers(gen_dir):
    eng = _engine(gen_dir, "chaos_gen")
    sched = eng.scheduler(max_slots=4)
    feed = {"h0": np.random.RandomState(4).randn(2, H).astype(np.float32)}
    try:
        want = eng.predict(feed)
        sched.generate(feed, timeout_ms=60000)
        faults.reset()
        faults.arm("serving.predict", p=1.0, times=1)
        h1 = sched.submit(feed, timeout_ms=60000)
        h2 = sched.submit(feed, timeout_ms=60000)
        for h in (h1, h2):
            with pytest.raises(GenerationAborted):
                h.result(timeout=WAIT)
        assert not sched._active.any()
        _same(sched.generate(feed, timeout_ms=60000), want)
    finally:
        faults.reset()
        sched.stop()


def test_generate_trips_the_shared_breaker(gen_dir):
    reg = ModelRegistry()
    # a reset timeout far above a loaded host's pauses: the circuit must
    # still read open when the test looks
    breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=0.5)
    eng, _ = reg.add("gen", model_dir=gen_dir, policy=BucketPolicy(max_batch_size=8),
                     breaker=breaker, scheduler_kw={"max_slots": 2}, device="cpu")
    sched = eng.scheduler()
    feed = {"h0": np.zeros((1, H), np.float32)}
    try:
        sched.generate(feed, timeout_ms=60000)
        faults.reset()
        faults.arm("serving.predict", p=1.0, times=2)
        for _ in range(2):
            with pytest.raises(GenerationAborted):
                sched.generate(feed, timeout_ms=60000)
        assert breaker.state() == "open" and reg.circuits()["gen"] == "open"
        with pytest.raises(CircuitOpenError):
            sched.submit(feed)
        time.sleep(0.6)  # the reset timeout: a half-open probe is admitted
        assert sched.generate(feed, timeout_ms=60000)["ids"].shape == (1, K, T)
        assert breaker.state() == "closed"
    finally:
        faults.reset()
        reg.stop()


def test_left_out_surfaces_raise(gen_dir, dense_dir):
    """What the scheduler refuses: a draft that is not there, draft_k < 1,
    a handoff whose arrays disagree on rows, an unknown cache quant, and a
    feed-forward model."""
    eng = _engine(gen_dir, "left_out")
    with pytest.raises(FileNotFoundError):
        ContinuousScheduler(eng, draft_model="no_such_draft")
    with pytest.raises(ValueError, match="draft_k"):
        ContinuousScheduler(eng, draft_model=gen_dir, draft_k=0)
    sched = ContinuousScheduler(eng)
    with pytest.raises(ValueError, match="row axis"):
        sched.submit_handoff((np.zeros((1, H), np.float32),), (np.zeros((2, 1), np.float32),))
    with pytest.raises(ValueError, match="prefix_cache_quant"):
        ContinuousScheduler(eng, prefix_cache_mb=1.0, prefix_cache_quant="int4")
    ff = _engine(dense_dir, "ff")
    assert ff.generation_spec() is None
    with pytest.raises(ValueError, match="not a generation model"):
        ff.scheduler()


def test_traced_generation_carries_the_request_id(gen_dir):
    """Traced, a request's admit, prefix and retire spans carry its id on
    the scheduler's thread; `context` scopes an id on the client's thread
    and restores the previous context."""
    from paddle_tpu_torch.obs import trace

    eng = _engine(gen_dir, "traced")
    sched = eng.scheduler(max_slots=2)
    try:
        with trace.tracing() as tr:
            with trace.context(request_id="outer"):
                trace.instant("mark", cat="test")
                sched.submit({"h0": np.zeros((1, H), np.float32)}, timeout_ms=60000,
                             request_id="rid-7").result(timeout=WAIT)
            trace.instant("after", cat="test")
        doc = tr.to_chrome()
    finally:
        sched.stop()
    assert trace.validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], []).append(e)
    assert {"gen.enqueue", "gen.prefix", "gen.admit", "gen.pool_step", "gen.retire"} <= set(
        by_name)
    for name in ("gen.prefix", "gen.admit", "gen.retire"):
        assert all(e["args"]["request_id"] == "rid-7" for e in by_name[name]), name
    assert by_name["mark"][0]["args"]["request_id"] == "outer"
    assert "request_id" not in by_name["after"][0].get("args", {})
    assert len({e["tid"] for e in by_name["gen.admit"] + by_name["mark"]}) == 2


# ------------------------------------------------------ sidecar and warmup --


def test_generation_sidecar_both_ways(gen_dir, tmp_path):
    """The JAX exporter's sidecar reads in the port; the port's for the
    same program equals it key for key (state fingerprint included), and
    the JAX engine sizes its pool from it."""
    with open(gen_dir + "/meta.json") as f:
        jmeta = json.load(f)["generation"]
    assert jmeta["state"] == [{"name": "h0", "dtype": "float32", "shape": [H]}]
    eng = _engine(gen_dir, "meta_port")
    assert eng.generation_meta == jmeta
    ptt.reset_default_programs()
    main, startup, outs = _gen_program(ptt)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    d = str(tmp_path / "port_gen")
    ptt.io.save_inference_model(d, ["h0"], list(outs), main_program=main, scope=scope)
    with open(d + "/meta.json") as f:
        pmeta = json.load(f)
    assert pmeta["generation"] == jmeta
    assert ptt.io.generation_state_fingerprint(pmeta["generation"]) == jmeta["state_fingerprint"]
    jeng = jserving.ServingEngine(d, policy=jserving.BucketPolicy(max_batch_size=2),
                                  model_name="meta_jax")
    jsched = jeng.scheduler(max_slots=2)
    try:
        jsched.warmup()
        assert jsched._state is not None  # the pool, from the port's sidecar
        feed = {"h0": np.random.RandomState(5).randn(1, H).astype(np.float32)}
        want = jsched.generate(feed, timeout_ms=120000)
    finally:
        jsched.stop()
    port = _engine(d, "port_gen")
    psched = port.scheduler(max_slots=2)
    try:
        got = psched.generate(feed, timeout_ms=60000)
    finally:
        psched.stop()
    np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=0,
                               atol=SCORE_TOL)


def test_warmup_sizes_the_pool_from_the_sidecar(gen_dir):
    eng = _engine(gen_dir, "warm_gen", max_batch_size=4)
    eng.warmup()
    sched = eng._scheduler
    try:
        assert sched is not None and sched._state is not None
        assert tuple(sched._state.mems[0].shape) == (sched.max_slots, K, H)
        out = eng.generate({"h0": np.zeros((2, H), np.float32)}, timeout_ms=60000)
        assert out["ids"].shape == (2, K, T)
        assert "generation" in eng.stats()
        st = sched.stats()["pool_step"]  # the CPU steps eagerly, no graph
        assert st["captures"] == 0 and st["eager_steps"] == sched.steps_total
    finally:
        sched.stop()


# ------------------------------------------------------------ prefix cache --


def test_prefix_row_key_is_independent_of_batch_neighbours():
    a = np.arange(8, dtype=np.float32).reshape(2, 4)
    b = np.stack([a[0], np.ones(4, np.float32)])
    assert prefix_row_key("fp", {"x": a}, 0) == prefix_row_key("fp", {"x": b}, 0)
    assert prefix_row_key("fp", {"x": a}, 1) != prefix_row_key("fp", {"x": b}, 1)
    assert prefix_row_key("fp", {"x": a}, 0) != prefix_row_key("other", {"x": a}, 0)


def test_prefix_cache_lru_byte_budget():
    c = PrefixCache(100)
    assert c.put("a", "A", 40) == 0 and c.put("b", "B", 40) == 0
    assert c.get("a") == "A"  # a is now the most recent
    assert c.put("c", "C", 40) == 1  # evicts b, the least recent
    assert "b" not in c and "a" in c and c.bytes == 80
    assert c.put("huge", "H", 101) == 0 and c.overflows == 1 and "huge" not in c
    assert c.get("b") is None
    s = c.stats()
    assert (s["hits"], s["misses"], s["evictions"], s["entries"]) == (1, 1, 1, 2)
    with pytest.raises(ValueError):
        PrefixCache(0)


def test_fp_cache_hit_bit_identical(gen_dir):
    rng = np.random.RandomState(6)
    feeds = [{"h0": rng.randn(1, H).astype(np.float32)} for _ in range(3)]
    eng = _engine(gen_dir, "pc_fp")
    sched = eng.scheduler(max_slots=1, prefix_cache_mb=4.0)
    try:
        fresh = [eng.generate(f, timeout_ms=60000) for f in feeds]
        prefixes = sched.prefixes_total
        again = [eng.generate(f, timeout_ms=60000) for f in feeds]
        assert sched.prefixes_total == prefixes  # every hit admitted from the cache
        for a, b in zip(fresh, again):
            _same(b, (a["ids"], a["scores"], a["lengths"]))
        pc = sched.stats()["prefix_cache"]
        assert (pc["insertions"], pc["hits"], pc["misses"]) == (3, 3, 3)
        _same(eng.generate(feeds[0], timeout_ms=60000), eng.predict(feeds[0]))
    finally:
        sched.stop()


def test_int8_cache_hit_bounded(gen_dir):
    """int8 entries admit within the JAX package's bound (scores within
    0.05: tests/test_gen_v3.py:162) and hold under half the fp bytes."""
    feed = {"h0": np.random.RandomState(1).randn(1, H).astype(np.float32)}
    nbytes = {}
    for quant in ("int8", None):
        eng = _engine(gen_dir, f"pc_{quant}")
        sched = eng.scheduler(max_slots=2, prefix_cache_mb=4.0, prefix_cache_quant=quant)
        try:
            fresh = eng.generate(feed, timeout_ms=60000)
            hit = eng.generate(feed, timeout_ms=60000)
            nbytes[quant] = sched.stats()["prefix_cache"]["bytes"]
        finally:
            sched.stop()
        assert np.abs(fresh["scores"] - hit["scores"]).max() < 0.05
        assert fresh["ids"].shape == hit["ids"].shape
    assert nbytes["int8"] < nbytes[None] / 2


# --------------------------------------------------------------------- HTTP --


@pytest.fixture()
def http_gen(gen_dir, dense_dir):
    reg = ModelRegistry()
    eng, _ = reg.add("default", model_dir=gen_dir, policy=BucketPolicy(max_batch_size=8),
                     scheduler_kw={"max_slots": 4}, timeout_ms=60000.0, device="cpu")
    reg.add("dense", model_dir=dense_dir, device="cpu")
    srv = make_server(reg)
    srv.serve_background()
    try:
        yield reg, eng, f"http://127.0.0.1:{srv.port}"
    finally:
        srv.shutdown()
        reg.stop()
        srv.server_close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=WAIT)


def test_http_generate_and_stream(http_gen):
    reg, eng, url = http_gen
    h0 = np.random.RandomState(5).randn(2, H).astype(np.float32)
    want = eng.predict({"h0": h0})
    with _post(url + "/generate", {"inputs": {"h0": h0.tolist()}, "timeout_ms": 60000}) as r:
        out = json.load(r)
    np.testing.assert_array_equal(np.asarray(out["outputs"]["ids"]), want[0])
    with _post(url + "/generate/default", {"inputs": {"h0": h0.tolist()}, "stream": True,
                                           "timeout_ms": 60000}) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        events = [json.loads(line) for line in r]
    kinds = [e["event"] for e in events]
    assert kinds[-1] == "done" and kinds.count("token") >= 2
    np.testing.assert_array_equal(np.asarray(events[-1]["outputs"]["ids"]), want[0])
    np.testing.assert_array_equal(np.asarray(events[-1]["outputs"]["scores"], np.float32),
                                  want[1])
    with urllib.request.urlopen(url + "/stats", timeout=WAIT) as r:
        assert json.load(r)["default"]["generation"]["retired_total"] >= 4
    with urllib.request.urlopen(url + "/healthz", timeout=WAIT) as r:
        assert json.load(r)["load"]["max_slots"] == 4
    with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
        m = r.read().decode()
    for needle in ("gen_slot_occupancy", "gen_first_token_seconds", "gen_token_seconds",
                   "gen_queue_depth", "gen_tokens_total"):
        assert "ptserving_" + needle in m, needle


def test_http_generate_errors(http_gen):
    reg, eng, url = http_gen
    for path, body, code, text in (
            ("/generate/dense", {"inputs": {"x": [[0, 0, 0, 0]]}}, 400, "not a generation"),
            ("/generate/nope", {"inputs": {"h0": [[0.0] * H]}}, 404, "unknown model"),
            ("/generate", {"not_inputs": 1}, 400, "bad request"),
            ("/prefill/nope", {"inputs": {"h0": [[0.0] * H]}}, 404, "unknown model"),
            ("/prefill/dense", {"inputs": {"x": [[0, 0, 0, 0]]}}, 400, "not a generation"),
            ("/admit/default", {}, 400, "bad magic")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + path, body)
        assert ei.value.code == code, path
        assert text in json.load(ei.value)["error"], path
        ei.value.close()


def test_chip_smoke_replays_the_v3_trace():
    """chip_smoke.py's phase 52 replays bench.py run_serving_gen_v3's
    shared-prefix trace through the port's fleetctl.traces: the same events
    (and digest) for its 48 requests as the JAX package's generate_trace."""
    import importlib.util
    import os

    from paddle_tpu.fleetctl.traces import TraceSpec, generate_trace, trace_digest

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n = cs.SGEN3["requests"]
    events = generate_trace(TraceSpec(duration_s=30.0, seed=17, base_rps=4.0,
                                      diurnal_amplitude=0.3, flash_crowds=(),
                                      shared_prefix_fraction=0.6, prefix_groups=3))[:n]
    got, digest = cs.sgen3_events(n)
    assert got == events and digest == trace_digest(events)
    assert sum(ev.get("prefix_group") is not None for ev in got) >= 8
