"""memory_optimize in the port (core/remat.py) on the CPU.

Each policy's step is the plain step's bits: the same losses and the same
state (parameters and Adam's moments, `torch.equal`) after every step, with
dropout, with an is_sparse table, with BatchNorm's running statistics
(conv2d + batch_norm and the fused_conv_bn route) and through
`run_window`; an op that draws inside a segment without declaring
`runs_once` raises. Against the JAX
package with memory_optimize on the same program and weights, f32 within
1e-5 of the loss (two GEMM libraries reduce in different orders). Torch
runs on one thread: its multi-threaded CPU reductions are not the same
bits run to run, remat or not. The CPU's proxy for the card's peak is the
largest total of live CPU allocations in a step, read from
torch.profiler's memory events: `full` below `dots_no_batch`, at most
`dots`, below the plain step; a saved_tensors_hooks count shows that
every tensor the plain step saves for its backward is then held by the
checkpoints instead.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import remat

POLICIES = ["full", "dots", "dots_no_batch"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh(pkg):
    if pkg is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    return pkg.Program(), pkg.Program()


# ------------------------------------- tests/test_memory_optimize.py's MLP --
def build_mlp(pkg, policy):
    main, startup = fresh(pkg)
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8])
        label = pkg.layers.data("label", shape=[1], dtype=np.int32)
        h = pkg.layers.fc(x, size=16, act="relu")
        h = pkg.layers.fc(h, size=16, act="tanh")
        logits = pkg.layers.fc(h, size=3)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    return main, startup, loss


def mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(16, 8).astype(np.float32),
            "label": rng.randint(0, 3, (16, 1)).astype(np.int32)}


def state_of(program, scope):
    return [scope.get(v.name) for v in program.persistables()]


def train_port(build, policy, feed, steps=4, amp=None, seed=11, init=None):
    """`steps` steps of build(ptt, policy) from `init` (name -> numpy), else
    its startup at `seed`: (losses, the state after)."""
    main, startup, loss = build(ptt, policy)
    if amp:
        main.set_amp(amp)
    scope, exe = ptt.Scope(), ptt.Executor(device="cpu")
    if init is None:
        exe.run(startup, scope=scope, seed=seed)
    else:
        ptt.io.params_from_numpy(scope, init, "cpu")
    losses = [exe.run(main, feed, [loss], scope=scope, seed=100 + i)[0] for i in range(steps)]
    return losses, state_of(main, scope)


def assert_same_bits(got, want):
    (gl, gs), (wl, ws) = got, want
    assert [np.asarray(v).tobytes() for v in gl] == [np.asarray(v).tobytes() for v in wl]
    assert len(gs) == len(ws) and all(torch.equal(a, b) for a, b in zip(gs, ws))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_baseline(policy):
    """tests/test_memory_optimize.py's test: here the plain run's bits."""
    assert_same_bits(train_port(build_mlp, policy, mlp_feed()),
                     train_port(build_mlp, None, mlp_feed()))


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="unknown remat policy"):
        ptt.memory_optimize(ptt.Program(), policy="bogus")
    main = ptt.Program()
    ptt.memory_optimize(main)
    assert main.remat_policy == "dots"  # the JAX package's default


def jax_init(main, startup, seed=11):
    exe, scope = pt.Executor(), pt.Scope()
    startup.random_seed = seed
    exe.run(startup, scope=scope)
    return exe, scope, {v.name: np.asarray(scope.get(v.name)) for v in main.persistables()
                        if scope.has(v.name)}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax(policy):
    """The same program under the same policy in both packages (the same
    dict), from the JAX startup's weights: losses within 1e-5, 4 SGD steps."""
    jm, js, jloss = build_mlp(pt, policy)
    exe, scope, init = jax_init(jm, js)
    want = [float(exe.run(jm, feed=mlp_feed(), fetch_list=[jloss], scope=scope)[0])
            for _ in range(4)]
    got, _ = train_port(build_mlp, policy, mlp_feed(), init=init)
    assert ptt.Program.from_dict(jm.to_dict()).to_dict() == build_mlp(ptt, policy)[0].to_dict()
    np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-5)


def test_a_jax_program_with_memory_optimize_trains_in_the_port():
    """The policy is not part of the program dict in either package: a
    program the JAX package built under memory_optimize crosses as a plain
    program, and takes the port's policy."""
    jm, js, jloss = build_mlp(pt, "full")
    _, _, init = jax_init(jm, js)
    pm = ptt.Program.from_dict(jm.to_dict())
    assert pm.remat_policy is None
    runs = {}
    for policy in (None, "full"):
        p = ptt.Program.from_dict(jm.to_dict())
        if policy:
            ptt.memory_optimize(p, policy)
        scope, exe = ptt.Scope(), ptt.Executor(device="cpu")
        ptt.io.params_from_numpy(scope, init, "cpu")
        runs[policy] = ([exe.run(p, mlp_feed(), [jloss.name], scope=scope)[0]
                         for _ in range(3)], state_of(p, scope))
    assert_same_bits(runs["full"], runs[None])
    assert runs[None][0][-1] < runs[None][0][0]


# --------------------------------------------- the transformer, 2 layers --
def build_tfm(pkg, policy, dropout=0.1):
    main, startup = fresh(pkg)
    with pkg.program_guard(main, startup):
        toks = pkg.layers.data("toks", shape=[16], dtype=np.int32)
        labels = pkg.layers.data("labels", shape=[16, 1], dtype=np.int32)
        logits = pkg.models.transformer_lm(toks, vocab_size=64, dim=64, num_heads=1,
                                           num_layers=2, max_len=16, dropout_prob=dropout)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, labels))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    return main, startup, loss


def tfm_feed(batch=4):
    rng = np.random.RandomState(0)
    return {"toks": rng.randint(0, 64, (batch, 16)).astype(np.int32),
            "labels": rng.randint(0, 64, (batch, 16, 1)).astype(np.int32)}


@pytest.mark.parametrize("amp", [None, "bfloat16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_transformer_with_dropout_is_the_plain_steps_bits(policy, amp):
    """dim 64, 2 layers, dropout_prob 0.1: each dropout draws once, between
    the segments, so every recompute reads the mask it drew."""
    main, _, _ = build_tfm(ptt, policy)
    spans = remat.segments(main.global_block().ops[:[o.type for o in main.global_block().ops]
                                                   .index("autodiff")])
    assert sum(not ck for _, _, ck in spans) == 4  # the four dropouts
    assert_same_bits(train_port(build_tfm, policy, tfm_feed(), steps=3, amp=amp),
                     train_port(build_tfm, None, tfm_feed(), steps=3, amp=amp))


# ----------------------------------------------------- an is_sparse table --
def build_sparse(pkg, policy):
    main, startup = fresh(pkg)
    with pkg.program_guard(main, startup):
        ids = pkg.layers.data("ids", shape=[-1, 1], dtype=np.int32, lod_level=1,
                              append_batch_size=False)
        y = pkg.layers.data("y", shape=[1])
        emb = pkg.layers.embedding(ids, size=[50, 8], is_sparse=True)
        h = pkg.layers.sequence_pool(pkg.layers.fc(emb, size=8, act="tanh"), "sum")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pkg.layers.fc(h, size=1), y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    return main, startup, loss


def sparse_feeds(lod_cls):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(3):
        seqs = [rng.randint(0, 50, (n, 1)).astype(np.int32) for n in (4, 2, 7)]
        out.append({"ids": lod_cls.from_sequences(seqs, capacity=16),
                    "y": rng.randn(3, 1).astype(np.float32)})
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_is_sparse_table_under_remat(policy):
    """The table's lookup runs once (one tape site a step), its SelectedRows
    update lazily: the plain run's bits, and the JAX package's losses and
    state within 1e-5."""
    from paddle_tpu.core.lod import LoDArray as JLoD

    jm, js, jloss = build_sparse(pt, policy)
    exe, jscope, init = jax_init(jm, js)
    want = [float(exe.run(jm, feed=f, fetch_list=[jloss], scope=jscope)[0])
            for f in sparse_feeds(JLoD)]
    runs = {}
    for pol in (None, policy):
        main, _, loss = build_sparse(ptt, pol)
        scope, pexe = ptt.Scope(), ptt.Executor(device="cpu")
        ptt.io.params_from_numpy(scope, init, "cpu")
        runs[pol] = ([pexe.run(main, f, [loss], scope=scope)[0]
                      for f in sparse_feeds(ptt.LoDArray)], state_of(main, scope))
    assert_same_bits(runs[policy], runs[None])
    np.testing.assert_allclose([float(v) for v in runs[policy][0]], want, rtol=1e-5)
    for v, t in zip(jm.persistables(), runs[policy][1]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jscope.get(v.name)), rtol=0,
                                   atol=1e-5)


# --------------------------------------------------- running statistics --
def build_bn(pkg, policy, fused=False):
    """Two conv + BatchNorm units, an fc and Momentum: through conv2d +
    batch_norm (NCHW), or through the fused protocol (NHWC: fused_conv_bn,
    bn_apply, conv2d, bn_stats, a fused_conv_bn with its prologue). Each BN
    writes its new running statistics under its Mean and Variance inputs'
    names, which no op declares as an output."""
    main, startup = fresh(pkg)
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", shape=[8, 8, 4] if fused else [4, 8, 8])
        label = pkg.layers.data("label", shape=[1], dtype=np.int32)
        if fused:
            h = pkg.layers.bn_apply(pkg.layers.fused_conv_bn(img, 8), act="relu")
            h = pkg.layers.conv2d(h, 8, 3, 1, 1, bias_attr=False, data_format="NHWC")
            h = pkg.layers.bn_apply(pkg.layers.fused_conv_bn(pkg.layers.bn_stats(h), 16))
        else:
            h = pkg.layers.conv2d(img, 8, 3, 1, 1, bias_attr=False)
            h = pkg.layers.batch_norm(h, act="relu")
            h = pkg.layers.conv2d(h, 16, 3, 2, 1, bias_attr=False)
            h = pkg.layers.batch_norm(h, act="relu")
        logits = pkg.layers.fc(h, size=3)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    return main, startup, loss


def bn_feed(fused):
    rng = np.random.RandomState(2)
    img = rng.standard_normal((8, 4, 8, 8)).astype(np.float32)
    return {"img": img.transpose(0, 2, 3, 1).copy() if fused else img,
            "label": rng.randint(0, 3, (8, 1)).astype(np.int32)}


@pytest.mark.parametrize("fused", [False, True], ids=["batch_norm", "fused_conv_bn"])
@pytest.mark.parametrize("policy", POLICIES)
def test_running_statistics_under_remat(policy, fused):
    """The new running statistics leave each segment that computes them:
    the plain run's bits over the whole scope after 3 steps (running
    statistics, parameters, velocities), the statistics moved from their
    startup values, and the JAX package's losses within 1e-5 relative and
    its state within 1e-5 (two convolution libraries reduce in different
    orders; f32)."""
    jm, js, jloss = build_bn(pt, policy, fused)
    exe, jscope, init = jax_init(jm, js)
    feed = bn_feed(fused)
    want = [float(exe.run(jm, feed=feed, fetch_list=[jloss], scope=jscope)[0]) for _ in range(3)]
    runs = {pol: train_port(functools.partial(build_bn, fused=fused), pol, feed, steps=3,
                            init=init) for pol in (None, policy)}
    assert_same_bits(runs[policy], runs[None])
    main = build_bn(ptt, policy, fused)[0]
    names = [v.name for v in main.persistables()]
    stats = [i for i, v in enumerate(main.persistables())
             if any(v.name in op.inputs.get("Mean", ()) or v.name in op.inputs.get("Variance", ())
                    for op in main.global_block().ops)]
    assert len(stats) == (6 if fused else 4)  # three BNs fused, two plain
    for i in stats:
        assert not np.array_equal(runs[policy][1][i].numpy(), init[names[i]]), names[i]
    np.testing.assert_allclose([float(v) for v in runs[policy][0]], want, rtol=1e-5)
    for v, t in zip(jm.persistables(), runs[policy][1]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jscope.get(v.name)), rtol=0, atol=1e-5,
                                   err_msg=v.name)


def test_an_undeclared_draw_in_a_segment_raises():
    """An op that draws from the run's generator without declaring
    `runs_once` would draw again in its recompute: inside a segment
    `ctx.generator()` raises instead."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.program import Operator

    @registry.register_op("test_undeclared_draw")
    def _kernel(ctx):
        gen = ctx.generator()
        x = ctx.input("X")
        ctx.set_output("Out", x * torch.rand(x.shape, generator=gen, device=gen.device))

    try:
        main, startup, loss = build_mlp(ptt, None)
        blk = main.global_block()
        i = next(i for i, op in enumerate(blk.ops) if op.type == "relu")
        relu = blk.ops[i]
        blk.ops.insert(i + 1, Operator(
            "test_undeclared_draw", {"X": relu.outputs["Out"]}, {"Out": relu.outputs["Out"]}, {}))
        scope, exe = ptt.Scope(), ptt.Executor(device="cpu")
        exe.run(startup, scope=scope, seed=0)
        exe.run(main, mlp_feed(), [loss], scope=scope)  # no remat: draws once
        ptt.memory_optimize(main, "full")
        with pytest.raises(RuntimeError, match="test_undeclared_draw.*runs_once"):
            exe.run(main, mlp_feed(), [loss], scope=scope)
    finally:
        registry._KERNELS.pop("test_undeclared_draw")


# ------------------------------------------------------------ the window --
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_run_window_under_remat_is_the_per_step_loop(policy):
    """scan_window=4 (the CPU runs each step eagerly on the window's
    buffers) against 4 per-step runs under the same policy: the same
    losses and state; the window's cache key holds the policy, so a window
    made before memory_optimize is not reused after it."""
    main, startup, loss = build_tfm(ptt, None)
    feed = tfm_feed()
    win = {k: np.stack([v] * 4) for k, v in feed.items()}
    scope, exe = ptt.Scope(), ptt.Executor(device="cpu")
    exe.run(startup, scope=scope, seed=5)
    main.random_seed = 7
    exe.run_window(main, win, [loss], scope=scope)
    assert exe.cache_stats["misses"] == 1
    init = ptt.io.state_to_numpy(scope, [v.name for v in main.persistables()])
    ptt.memory_optimize(main, policy)
    (ys,), _ = exe.run_window(main, win, [loss], scope=scope)
    assert exe.cache_stats["misses"] == 2
    scope2 = ptt.Scope()
    ptt.io.params_from_numpy(scope2, init, "cpu")
    per_step = [exe.run(main, feed, [loss], scope=scope2)[0] for _ in range(4)]
    assert ys.numpy().tobytes() == np.stack(per_step).tobytes()
    assert all(torch.equal(a, b) for a, b in zip(state_of(main, scope), state_of(main, scope2)))


def test_run_window_with_batch_norm_under_remat():
    """The conv2d + batch_norm program through scan_window=4 under `full`
    against 4 per-step remat steps: the same losses and the whole scope,
    the running statistics included, and those moved."""
    main, startup, loss = build_bn(ptt, "full")
    feed = bn_feed(False)
    win = {k: np.stack([v] * 4) for k, v in feed.items()}
    stats = [op.inputs[s][0] for op in main.global_block().ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")]
    runs = []
    for window in (True, False):
        scope, exe = ptt.Scope(), ptt.Executor(device="cpu")
        exe.run(startup, scope=scope, seed=5)
        init = {n: scope.get(n).clone() for n in stats}
        if window:
            (ys,), _ = exe.run_window(main, win, [loss], scope=scope)
            losses = ys.numpy()
        else:
            losses = np.stack([exe.run(main, feed, [loss], scope=scope)[0] for _ in range(4)])
        runs.append((losses, state_of(main, scope)))
        assert len(stats) == 4 and not any(torch.equal(scope.get(n), init[n]) for n in stats)
    assert runs[0][0].tobytes() == runs[1][0].tobytes()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ----------------------------------------------------- what the step keeps --
def step_peak_bytes(policy):
    """The largest total of live CPU allocations during one step (after a
    warm-up step), from torch.profiler's memory events."""
    main, startup, loss = build_tfm(ptt, policy, dropout=0.0)
    scope, exe = ptt.Scope(), ptt.Executor(device="cpu")
    exe.run(startup, scope=scope, seed=0)
    feed = tfm_feed(batch=32)
    exe.run(main, feed, [loss], scope=scope)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        exe.run(main, feed, [loss], scope=scope)
    cur = peak = 0
    for e in sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "[memory]"),
                    key=lambda e: e.start_ns()):
        cur += e.nbytes()
        peak = max(peak, cur)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t):
        exe.run(main, feed, [loss], scope=scope)
    return peak, len(packed)


def test_remat_lowers_the_peak():
    peaks = {p: step_peak_bytes(p) for p in [None] + POLICIES}
    assert peaks["full"][0] < peaks["dots_no_batch"][0] <= peaks["dots"][0] < peaks[None][0]
    # the plain step's saved tensors pass the outermost hooks; under remat
    # the checkpoints hold every one of them instead
    assert peaks[None][1] > 0 and all(peaks[p][1] == 0 for p in POLICIES)


def test_segments_rule():
    """ceil(sqrt(n)) ops a segment; ops that run once stand alone."""
    main, _, _ = build_tfm(ptt, None)
    ops = main.global_block().ops
    fwd = ops[:[o.type for o in ops].index("autodiff")]
    spans = remat.segments(fwd)
    assert [a for a, _, _ in spans] == sorted(a for a, _, _ in spans)
    assert spans[0][0] == 0 and spans[-1][1] == len(fwd)
    assert all(b == c for (_, b, _), (c, _, _) in zip(spans, spans[1:]))
    size = int(np.ceil(np.sqrt(len(fwd))))
    for a, b, ck in spans:
        assert (b - a <= size) if ck else (b - a == 1 and fwd[a].type == "dropout")


def test_jax_is_on_the_cpu():
    assert jnp.zeros(1).devices().pop().platform == "cpu"
