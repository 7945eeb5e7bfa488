"""The layer DSL and optimizer front end, end to end: bench.py's `lstm`
program (`_build_lstm_train`, bench.py:261-317: embedding, fc, the
two-layer `stacked_lstm2`, the last step, fc, softmax_with_cross_entropy,
mean; Adam(2e-3) with L2Decay(8e-4) and GradientClipByGlobalNorm(25))
built by each package's own front end, then trained by both from one
numpy state.

The small width (V=64, emb=32, H=384, T=6, B=8) is the smallest at which
the JAX package dispatches its Pallas LSTM kernels (`lstm_supported`:
384 <= H, H a multiple of 128, B a multiple of 8); its side runs them in
interpret mode on the kernel path, and its scans with both fused flags
off. The parameters are normal/sqrt(fan_in) from a seed (the startup's
Xavier values give the same program; the seed makes the state the
same on both sides).

Tolerances (the bounds of tests/test_torch_train.py where they fit):

- f32: the loss within 1e-5 relative, every gradient within 2e-5 of its
  largest element (measured: at most 5.4e-6, the output bias), after two
  steps every parameter value within 0.05 lr (measured 3.6e-4 lr) and the
  moments within 5e-5 of their largest element.
- bf16 amp. The JAX side compiles its step with XLA's excess precision
  off (`xla_allow_excess_precision` in jit's compiler_options, what
  --xla_allow_excess_precision=false sets for a process), so that its
  compiled step rounds where its ops round one by one, as the port does.
  With XLA's default the compiler may skip a rounding inside a fused
  loop or loss: the classifier's bf16 logits then reach the f32
  log-softmax unrounded and every first-step loss differs from the port's
  by 2e-4 relative, as the attention decoder's softmax does in
  tests/test_torch_train.py (`test_bf16_scan_decoder_parts_only_under_
  xla_excess_precision`). With it off, the first step's loss is the same
  bits on both paths (held to 1e-5 relative); the second step's within
  1e-3 relative (measured: the same bits on the kernel path, 3.3e-4 on
  the scans, where a first-step gradient near 0 flips the sign of its
  Adam step: one step moves the loss by 2.3e-3). Weight gradients (2-D)
  within 5e-2 of their largest element with at most 3% of values beyond
  1% of it (measured 1.3e-2 and 0%); bias gradients, sums over B·T bf16
  cotangents that nearly cancel (the two-class output bias's are
  [s, -s]), within 0.1 of their largest element (measured 6.25e-2). The
  state after two steps: test_torch_train's bf16 bounds in units of this
  program's lr, on the gradient as Adam saw it (the L2 decay in it; see
  `_assert_two_steps_close`): at most 3% of a parameter's values beyond
  0.1 lr (measured 2.0%, a scan bias), the held values within 0.5 lr
  (measured 0.30 lr); a row whose update is lost fails it.
"""

import functools
import os
import sys
from collections import Counter

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu as pt  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu import models  # noqa: E402
from paddle_tpu.core.lod import LoDArray as JaxLoD  # noqa: E402
from paddle_tpu.flags import FLAGS  # noqa: E402
from paddle_tpu.ops import pallas_kernels  # noqa: E402
from test_torch_train import _BF16, _F32, _assert_state_close  # noqa: E402

WIDTHS = {
    # bench.py's lstm entry at its defaults: BENCH_HIDDEN=512, BENCH_SEQLEN=100
    "full": dict(vocab=30000, emb=128, hidden=512, max_len=100),
    "small": dict(vocab=64, emb=32, hidden=384, max_len=6),
}
B = 8
LR, L2, CLIP = 2e-3, 8e-4, 25.0
# the SGD + L1Decay case: a clip that binds (the gradients' global norm
# is above 0.1), so each step moves the parameters by lr * 0.01 = 0.5 in
# norm, spread over 2.4M values: moves of up to 5e-3, far above the f32
# ulp of the parameters they are read from
SGD_LR, L1, SGD_CLIP = 50.0, 8e-4, 0.01
_BF16_LOSS2 = 1e-3
_BF16_BIAS_GRAD = 0.1


def build(pkg, vocab, emb, hidden, max_len, clip=CLIP, opt="adam"):
    """bench.py's _build_lstm_train through `pkg`'s front end (paddle_tpu or
    paddle_tpu_torch), names counted from 0; opt="sgd" swaps bench.py's
    Adam + L2Decay for SGD + L1Decay. Returns (main, startup, loss)."""
    if pkg is pt:
        pt.reset()
        zoo = models
    else:
        ptt.reset_default_programs()
        zoo = ptt.models
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        words = pkg.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        label = pkg.layers.data("label", shape=[1], dtype=np.int32)
        logits = zoo.lstm_benchmark_net(words, vocab_size=vocab, emb_dim=emb, hidden=hidden,
                                        max_len=max_len)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        clip = pkg.optimizer.GradientClipByGlobalNorm(clip)
        if opt == "adam":
            optimizer = pkg.optimizer.Adam(
                learning_rate=LR, regularization=pkg.regularizer.L2Decay(L2), grad_clip=clip)
        else:
            optimizer = pkg.optimizer.SGD(
                learning_rate=SGD_LR, regularization=pkg.regularizer.L1Decay(L1), grad_clip=clip)
        optimizer.minimize(loss)
    return prog, startup, loss


@pytest.mark.parametrize("width", sorted(WIDTHS) + ["small-sgd"])
def test_program_matches_jax(width):
    """Main and startup serialize to the JAX package's dicts, with the ops
    the JAX package builds for bench.py's program (and, at the small width,
    for it with SGD + L1Decay)."""
    import json

    opt = "sgd" if width.endswith("-sgd") else "adam"
    size = WIDTHS[width.split("-")[0]]
    j_main, j_start, _ = build(pt, **size, opt=opt)
    p_main, p_start, _ = build(ptt, **size, opt=opt)
    for j, p in ((j_main, p_main), (j_start, p_start)):
        assert json.loads(json.dumps(p.to_dict())) == json.loads(json.dumps(j.to_dict()))
    ops = Counter(o.type for o in p_main.global_block().ops)
    update = {"adam": 9} if opt == "adam" else {"sign": 9, "sgd": 9}
    assert ops == {"lookup_table": 1, "mul": 2, "stacked_lstm2": 1, "sequence_pool": 1,
                   "elementwise_add": 10, "softmax_with_cross_entropy": 1, "mean": 1,
                   "autodiff": 1, "scale": 9, "clip_by_global_norm": 1, **update}
    # the three biases and the lr, and Adam's four accumulators a parameter
    assert Counter(o.type for o in p_start.global_block().ops) == {
        "gaussian_random": 1, "uniform_random": 5,
        "fill_constant": 40 if opt == "adam" else 4}
    assert len(p_main.parameters()) == 9
    assert all(o.attrs.get("is_optimizer_op") for o in p_main.global_block().ops[8:])


# ------------------------------------------------------------- training --
def make_state_and_batches(opt="adam"):
    """The small program's startup state (run by the port on the CPU) with
    seeded parameters, and two ragged batches of (sequences, labels); the
    same parameters and batches for either optimizer."""
    main, startup, _ = build(ptt, **WIDTHS["small"], opt=opt)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=1)
    state = ptt.io.state_to_numpy(scope, [v.name for v in main.persistables()])
    rng = np.random.RandomState(0)
    for v in main.parameters():
        shape = state[v.name].shape
        state[v.name] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    T, V = WIDTHS["small"]["max_len"], WIDTHS["small"]["vocab"]
    batches = []
    for _ in range(2):
        lens = rng.randint(2, T + 1, size=B)
        lens[0] = T
        batches.append(([rng.randint(0, V, size=n).astype(np.int32) for n in lens],
                        rng.randint(0, 2, (B, 1)).astype(np.int32)))
    return state, batches


def _feed(lod_cls, batch):
    seqs, label = batch
    return {"words": lod_cls.from_sequences(seqs, capacity=B * WIDTHS["small"]["max_len"],
                                            max_seqs=B), "label": label}


def run_jax(state, batches, amp, fused, fetch_extra=(), clip=CLIP, opt="adam"):
    """Two steps of the JAX package's build; the first fetches every
    P@GRAD and `fetch_extra`. Returns losses, grads, extras, final state
    and the number of _lstm_pallas_raw traces."""
    from jax import numpy as jnp

    prog, _, loss = build(pt, **WIDTHS["small"], clip=clip, opt=opt)
    saved = (FLAGS.fused_rnn_interpret, FLAGS.use_fused_rnn)
    raw = pallas_kernels._lstm_pallas_raw
    traces = []
    try:
        FLAGS.fused_rnn_interpret = FLAGS.use_fused_rnn = fused
        pallas_kernels._lstm_pallas_raw = lambda *a: traces.append(1) or raw(*a)
        scope = pt.global_scope()
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        prog.set_amp(amp)
        exe = pt.Executor()
        names = [p.name + "@GRAD" for p in prog.parameters()]
        first = exe.run(prog, feed=_feed(JaxLoD, batches[0]),
                        fetch_list=[loss.name] + names + list(fetch_extra))
        mid = {n: np.array(scope.get(n), np.float32) for n in state}
        second = exe.run(prog, feed=_feed(JaxLoD, batches[1]), fetch_list=[loss.name])
        final = {n: np.array(scope.get(n), np.float32) for n in state}
    finally:
        FLAGS.fused_rnn_interpret, FLAGS.use_fused_rnn = saved
        pallas_kernels._lstm_pallas_raw = raw
    k = 1 + len(names)
    return dict(loss=[float(first[0]), float(second[0])],
                grads={n: np.asarray(g, np.float32) for n, g in zip(names, first[1:k])},
                extra=[np.asarray(e, np.float32) for e in first[k:]], mid=mid, state=final,
                traces=len(traces))


def run_port(state, batches, amp, fused, fetch_extra=(), clip=CLIP, opt="adam"):
    prog, _, loss = build(ptt, **WIDTHS["small"], clip=clip, opt=opt)
    prog.set_amp(amp)
    saved = ptt.FLAGS.use_fused_rnn
    try:
        ptt.FLAGS.use_fused_rnn = fused
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, "cpu")
        exe = ptt.Executor(device="cpu")
        names = [p.name + "@GRAD" for p in prog.parameters()]
        first = exe.run(prog, _feed(ptt.LoDArray, batches[0]),
                        [loss.name] + names + list(fetch_extra), scope=scope)
        mid = ptt.io.state_to_numpy(scope, list(state))
        second = exe.run(prog, _feed(ptt.LoDArray, batches[1]), [loss.name], scope=scope)
    finally:
        ptt.FLAGS.use_fused_rnn = saved
    k = 1 + len(names)
    return dict(loss=[float(first[0]), float(second[0])], grads=dict(zip(names, first[1:k])),
                extra=list(first[k:]), mid=mid, state=ptt.io.state_to_numpy(scope, list(state)))


def run_jax_bf16(state, batches, fused):
    """run_jax in bf16 with every jit compiled with XLA's excess precision
    off (as --xla_allow_excess_precision=false sets it for a process), so
    the JAX package's compiled step rounds where its ops round."""
    import jax

    jit = jax.jit
    try:
        jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        return run_jax(state, batches, "bfloat16", fused)
    finally:
        jax.jit = jit


@pytest.fixture(scope="module")
def runs():
    """Two steps of both packages by variant, from one state: `runs.state`
    (Adam's), `runs.sgd_state` (the same parameters and SGD's lr)."""
    state, batches = make_state_and_batches()
    sgd_state, _ = make_state_and_batches("sgd")
    cache = {}

    def get(variant):
        if variant in cache:
            return cache[variant]
        if variant == "sgd-l1-clip":
            # f32 on the scans; the first step fetches the clip's inputs and outputs
            prog, _, _ = build(ptt, **WIDTHS["small"], opt="sgd")
            clip_op = next(o for o in prog.global_block().ops if o.type == "clip_by_global_norm")
            kw = dict(fetch_extra=clip_op.inputs["X"] + clip_op.outputs["Out"], clip=SGD_CLIP,
                      opt="sgd")
            cache[variant] = (run_jax(sgd_state, batches, None, False, **kw),
                              run_port(sgd_state, batches, None, False, **kw))
        else:
            path, dt = variant.split("-")
            fused = path == "kernels"
            j = (run_jax(state, batches, None, fused) if dt == "f32"
                 else run_jax_bf16(state, batches, fused))
            amp = None if dt == "f32" else "bfloat16"
            cache[variant] = (j, run_port(state, batches, amp, fused))
        return cache[variant]

    get.state, get.sgd_state = state, sgd_state
    return get


VARIANTS = ["kernels-f32", "scan-f32", "kernels-bf16", "scan-bf16", "sgd-l1-clip"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_steps_match_jax(runs, variant):
    """Both losses, the nine P@GRAD of the first step with the L2 decay and
    the clip in them, and every parameter, moment, beta power and the
    learning rate after two steps. `sgd-l1-clip`: SGD with L1Decay and a
    clip that binds, f32 on the scans."""
    j, p = runs(variant)
    f32 = not variant.endswith("bf16")
    assert (j["traces"] >= 2) == variant.startswith("kernels"), j["traces"]
    loss_tol = [_F32["loss"]] * 2 if f32 else [_F32["loss"], _BF16_LOSS2]
    for a, b, tol in zip(j["loss"], p["loss"], loss_tol):
        assert np.isfinite(b) and abs(a - b) <= tol * abs(a), (a, b)
    assert set(p["grads"]) == set(j["grads"]) and len(p["grads"]) == 9
    for name, a in j["grads"].items():
        b = p["grads"][name]
        assert b.shape == a.shape and b.dtype == np.float32, name
        scale = float(np.abs(a).max())
        d = np.abs(a - b)
        if f32:
            assert d.max() <= _F32["grad"] * scale, (name, d.max() / scale)
        elif a.ndim == 1:
            assert d.max() <= _BF16_BIAS_GRAD * scale, (name, d.max() / scale)
        else:
            assert d.max() <= _BF16["grad"] * scale, (name, d.max() / scale)
            assert np.mean(d > 0.01 * scale) <= _BF16["grad_share"], name
    if variant == "sgd-l1-clip":
        assert set(p["state"]) == set(j["state"]) and len(j["state"]) == 9 + 1
        _assert_sgd_steps_close(p, j, runs.sgd_state)
        return
    assert set(p["state"]) == set(j["state"]) and len(j["state"]) == 9 * 5 + 1
    _assert_two_steps_close(p, j, runs.state, _F32 if f32 else None)


def _assert_sgd_steps_close(p, j, state):
    """Each parameter's move over the two SGD steps within 1e-4 of the JAX
    package's largest (measured: 2.3e-5, an fc weight), and the lr
    unchanged. A bound in units of lr, as Adam's, would not see a lost
    update here: the clip holds each step to a norm of lr * 0.01."""
    for n, w in j["state"].items():
        if n.endswith(".lr"):
            np.testing.assert_array_equal(p["state"][n], w)
            continue
        want, got = w - state[n], p["state"][n] - state[n]
        scale = float(np.abs(want).max())
        assert scale > 0, n
        assert np.abs(got - want).max() <= 1e-4 * scale, (n, np.abs(got - want).max() / scale)


def _assert_two_steps_close(p, j, state, tol=None):
    """test_torch_train's state bounds (f32 `tol`, else bf16), in units of
    this program's lr. In bf16 the values held within 0.5 lr are those
    whose first-step gradient as Adam saw it, with the L2 decay in it,
    exceeds a share of the parameter's largest that a gradient within its
    bound cannot flip: 5% for weights, 10% for biases, whose moments are
    held to 0.2 of their largest (a bias gradient's 0.1, squared)."""
    seen = {n: j["grads"][n + "@GRAD"] + L2 * state[n] for n in
            (k[: -len("@GRAD")] for k in j["grads"])}
    grads = {n + "@GRAD": g for n, g in seen.items()}
    if tol is not None:
        _assert_state_close(p["state"], j["state"], tol, grads, lr=LR)
        return
    bias = {n for n, g in seen.items() if g.ndim == 1}
    for subset, t in ((lambda n: not any(b in n for b in bias), _BF16),
                      (lambda n: any(b in n for b in bias),
                       dict(_BF16, robust_grad=_BF16_BIAS_GRAD, moment=2 * _BF16_BIAS_GRAD,
                            moment_share=1.0))):
        keep = [n for n in j["state"] if subset(n)]
        _assert_state_close({n: p["state"][n] for n in keep}, {n: j["state"][n] for n in keep},
                            t, grads, lr=LR)


def test_state_bounds_reject_an_update_lost_in_one_row(runs):
    """One embedding row left where it started fails the bf16 bounds."""
    j, p = runs("kernels-bf16")
    name = "embedding_0.w_1"
    g = np.abs(j["grads"][name + "@GRAD"])
    row = int(g.max(1).argmax())
    faulty = dict(p["state"])
    faulty[name] = p["state"][name].copy()
    faulty[name][row] = runs.state[name][row]
    with pytest.raises(AssertionError):
        _assert_two_steps_close(dict(p, state=faulty), j, runs.state)


def test_the_clip_binds(runs):
    """With max_global_norm below the gradients' global norm, the clipped
    gradients (the clip op's outputs) are the regularized gradients (the
    L1 decay in them) scaled to that norm, in both packages alike (the
    `sgd-l1-clip` run: f32, on the scans)."""
    j, p = runs("sgd-l1-clip")
    n = len(p["extra"]) // 2
    gnorm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in p["extra"][:n]))
    assert gnorm > 0.1, gnorm  # the clip is at 0.01: it scales by 1/10 or less
    clipped = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in p["extra"][n:]))
    assert abs(clipped - SGD_CLIP) <= 1e-7, clipped
    for g, c in zip(p["extra"][:n], p["extra"][n:]):
        np.testing.assert_allclose(c, g * (SGD_CLIP / gnorm), rtol=1e-5, atol=1e-12)
    for a, b in zip(j["extra"], p["extra"]):
        assert np.abs(a - b).max() <= _F32["grad"] * np.abs(a).max()


def test_sequence_pool_last_on_a_ragged_batch():
    """The last token of each sequence, zeros for the absent sequences past
    num_seqs, as the JAX package's sequence_pool(last) gives them."""
    rng = np.random.RandomState(3)
    seqs = [rng.randn(n, 4).astype(np.float32) for n in (3, 1, 5, 2)]
    outs = []
    for pkg, lod in ((pt, JaxLoD), (ptt, ptt.LoDArray)):
        if pkg is pt:
            pt.reset()
        else:
            ptt.reset_default_programs()
        prog = pkg.Program()
        with pkg.program_guard(prog, pkg.Program()):
            x = pkg.layers.data("x", shape=[-1, 4], lod_level=1, append_batch_size=False)
            out = pkg.layers.sequence_pool(x, "last")
        exe = pkg.Executor() if pkg is pt else pkg.Executor(device="cpu")
        kw = {} if pkg is pt else {"scope": ptt.Scope()}
        feed = {"x": lod.from_sequences(seqs, capacity=16, max_seqs=6)}
        outs.append(np.asarray(exe.run(prog, feed=feed, fetch_list=[out.name], **kw)[0]))
    want = np.stack([s[-1] for s in seqs] + [np.zeros(4, np.float32)] * 2)
    np.testing.assert_array_equal(outs[1], want)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_what_is_not_ported_refuses_to_build():
    ptt.reset_default_programs()
    with ptt.program_guard(ptt.Program(), ptt.Program()):
        x = ptt.layers.data("x", shape=[-1, 4], lod_level=1, append_batch_size=False)
        # sparse feed slots are ported (tests/test_torch_sparse.py): they build
        assert ptt.layers.data("s", shape=[10], sparse_format="binary").sparse_format == \
            "binary"
        # the vocab-sharded embedding is ported (tests/test_torch_parallel.py
        # trains it on two ranks): it builds, its table striped over mp
        ptt.models.lstm_benchmark_net(x, 10, sharded_embedding_axis="mp")
        table = next(o for o in ptt.default_main_program().global_block().ops
                     if o.type == "lookup_table").inputs["W"][0]
        assert ptt.default_main_program().global_block().var(table).sharding == ("mp", None)
    # schedules, pruning hooks and lr multipliers are ported: they build
    # (tests/test_torch_optimizers.py trains them against the JAX package)
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        x = ptt.layers.data("x", shape=[4])
        y = ptt.layers.fc(x, size=3, param_attr=ptt.ParamAttr(
            learning_rate=0.5, update_hooks=[ptt.param_attr.StaticPruningHook()]))
        ptt.optimizer.Adam(lr_schedule=ptt.optimizer.ExponentialDecay(2, 0.5)).minimize(
            ptt.layers.mean(y))
    assert {"lr_schedule", "apply_mask", "scale"} <= {op.type for op in main.global_block().ops}


@pytest.mark.parametrize("case", ["kernels-reverse", "scan-peepholes-reverse"])
def test_dynamic_lstm_op_matches_jax(case):
    """dynamic_lstm through both front ends and executors, f32 forward:
    reversed on the kernel path (the JAX side's Pallas kernel in interpret
    mode, at H=384 where it dispatches it), and with peepholes, which take
    the scans on both sides (the bias splits into 4H gates and 3H
    peepholes)."""
    from jax import numpy as jnp

    peep, fused = "peepholes" in case, case.startswith("kernels")
    progs = {}
    for pkg in (pt, ptt):
        pt.reset() if pkg is pt else ptt.reset_default_programs()
        prog = pkg.Program()
        with pkg.program_guard(prog, pkg.Program()):
            x = pkg.layers.data("x", shape=[-1, 4 * 384], lod_level=1, append_batch_size=False)
            pkg.layers.dynamic_lstm(x, size=4 * 384, use_peepholes=peep, is_reverse=True)
        progs[pkg] = prog
    op = progs[ptt].global_block().ops[-1]
    fetch = [op.outputs[k][0] for k in ("Hidden", "LastH", "LastC")]
    rng = np.random.RandomState(7)
    state = {v.name: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
             for v in progs[ptt].parameters()}
    assert sum(a.size for a in state.values()) == 384 * 4 * 384 + (7 if peep else 4) * 384
    seqs = [rng.randn(n, 4 * 384).astype(np.float32) for n in (5, 2, 4, 1, 5, 3, 2, 5)]

    saved = (FLAGS.fused_rnn_interpret, FLAGS.use_fused_rnn, ptt.FLAGS.use_fused_rnn)
    raw = pallas_kernels._lstm_pallas_raw
    traces = []
    try:
        FLAGS.fused_rnn_interpret = FLAGS.use_fused_rnn = ptt.FLAGS.use_fused_rnn = fused
        pallas_kernels._lstm_pallas_raw = lambda *a: traces.append(1) or raw(*a)
        for n, v in state.items():
            pt.global_scope().set(n, jnp.asarray(v))
        want = pt.Executor().run(progs[pt], feed={"x": JaxLoD.from_sequences(
            seqs, capacity=40, max_seqs=8)}, fetch_list=fetch)
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, "cpu")
        got = ptt.Executor(device="cpu").run(progs[ptt], {"x": ptt.LoDArray.from_sequences(
            seqs, capacity=40, max_seqs=8)}, fetch, scope=scope)
    finally:
        FLAGS.fused_rnn_interpret, FLAGS.use_fused_rnn, ptt.FLAGS.use_fused_rnn = saved
        pallas_kernels._lstm_pallas_raw = raw
    assert bool(traces) == fused
    for name, a, b in zip(("Hidden", "LastH", "LastC"), want, got):
        a = np.asarray(a.data if isinstance(a, JaxLoD) else a, np.float32)
        b = (b.data if isinstance(b, ptt.LoDArray) else b)
        np.testing.assert_allclose(np.asarray(b, np.float32), a, rtol=0, atol=1e-5, err_msg=name)
