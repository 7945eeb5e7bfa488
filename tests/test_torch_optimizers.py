"""The optimizers, learning-rate schedules, clips and parameter hooks of
the port against the JAX package (optimizer/__init__.py, param_attr.py,
ops/optimizer_ops.py).

Each case builds one small program with both front ends (equal program
dicts: the accumulators carry the JAX package's names), takes the JAX
startup's state, and trains three steps in both packages on the same
seeded feeds: the losses, and every persistable (parameters, moments,
steps, masks, averages) after the last step, within 1e-5 of each value's
scale (the largest |value|, at least 1e-3) in f32. Adaptive steps divide
by a gradient's own magnitude, where a near-zero gradient's rounding moves
its parameter by a share of the learning rate: those bounds also allow 1%
of the learning rate a step. Under bf16 amp the bound is 2e-2 of the
scale, the JAX side compiled with XLA's excess precision off; the bf16
case takes Momentum, whose state moves linearly with the gradient: the
two packages' bf16 gradients differ by a bf16 ulp of the largest
(XLA's and torch's orders of rounding), which an adaptive optimizer
divides by a small gradient's own magnitude (RMSProp's first moment moved
by a quarter of its learning rate).

- Adagrad, Adadelta, RMSProp (with momentum), DecayedAdagrad, Adamax and
  Ftrl (both lr_power branches).
- The five schedules (two with staircase or cycle), through lr_schedule
  computed on the device from the step counter.
- GradientClipByValue, GradientClipByNorm and the global norm on the
  optimizer; per-parameter clips; ParamAttr(learning_rate) multipliers.
- StaticPruningHook: the mask from the startup program, the weights kept
  masked after each update (exactly the masked share zero).
- ModelAverage: the averages' accumulators, then apply() and restore().
- An is_sparse embedding (SelectedRows gradients) under an L2 decay and a
  clip, which it skips as the JAX package's does, with each optimizer that
  has a SelectedRows branch (sgd, momentum, adagrad, adam).
- proximal_gd, which no front-end optimizer emits, op against op.
- A checkpoint the JAX Trainer writes with RMSProp and a schedule resumes
  in the port's Trainer, and the other way round, on the uninterrupted
  run's costs and parameters.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as tio

TOL = {None: 1e-5, "bfloat16": 2e-2}
LR_SHARE = 1e-2
STEPS, BATCH, VOCAB = 3, 8, 20


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(m, kind, **kw):
    o = m.optimizer
    return {
        "sgd": lambda: o.SGD(learning_rate=0.1, **kw),
        "momentum": lambda: o.Momentum(learning_rate=0.05, momentum=0.9, **kw),
        "adam": lambda: o.Adam(learning_rate=0.01, **kw),
        "adagrad": lambda: o.Adagrad(learning_rate=0.1, **kw),
        "adadelta": lambda: o.Adadelta(learning_rate=1.0, rho=0.9, **kw),
        "rmsprop": lambda: o.RMSProp(learning_rate=0.01, momentum=0.9, **kw),
        "decayed_adagrad": lambda: o.DecayedAdagrad(learning_rate=0.1, **kw),
        "adamax": lambda: o.Adamax(learning_rate=0.01, **kw),
        "ftrl": lambda: o.Ftrl(learning_rate=0.1, l1=0.01, l2=0.01, **kw),
        "ftrl_power": lambda: o.Ftrl(learning_rate=0.1, l1=0.001, lr_power=-0.6, **kw),
    }[kind]()


def _schedule(m, kind):
    o = m.optimizer
    return {
        "exponential": lambda: o.ExponentialDecay(decay_steps=2, decay_rate=0.5,
                                                  staircase=True),
        "natural_exp": lambda: o.NaturalExpDecay(decay_steps=2, decay_rate=0.3),
        "inverse_time": lambda: o.InverseTimeDecay(decay_steps=1, decay_rate=0.5),
        "polynomial": lambda: o.PolynomialDecay(decay_steps=2, end_learning_rate=0.01,
                                                power=2.0, cycle=True),
        "piecewise": lambda: o.PiecewiseDecay(boundaries=[2, 3], values=[0.1, 0.05, 0.01]),
    }[kind]()


# case: (optimizer, options); the options name the variant's surfaces
CASES = {
    "adagrad": ("adagrad", {}),
    "adadelta": ("adadelta", {}),
    "rmsprop": ("rmsprop", {}),
    "decayed_adagrad": ("decayed_adagrad", {}),
    "adamax": ("adamax", {}),
    "ftrl": ("ftrl", {}),
    "ftrl_power": ("ftrl_power", {}),
    "momentum-bf16": ("momentum", {"amp": "bfloat16", "schedule": "piecewise",
                                   "clip": "norm"}),
    "sched-exponential": ("sgd", {"schedule": "exponential"}),
    "sched-natural_exp": ("momentum", {"schedule": "natural_exp"}),
    "sched-inverse_time": ("sgd", {"schedule": "inverse_time"}),
    "sched-polynomial": ("adam", {"schedule": "polynomial"}),
    "sched-piecewise": ("sgd", {"schedule": "piecewise"}),
    "clip-value": ("sgd", {"clip": "value"}),
    "clip-norm": ("momentum", {"clip": "norm"}),
    "clip-global": ("adagrad", {"clip": "global"}),
    "param-clip-lr": ("momentum", {"param_clip": True, "param_lr": 0.5}),
    "pruning": ("adam", {"prune": 0.5}),
    "model_average": ("sgd", {"average": True}),
    "sparse-sgd": ("sgd", {"sparse": True}),
    "sparse-momentum": ("momentum", {"sparse": True}),
    "sparse-adagrad": ("adagrad", {"sparse": True}),
    "sparse-adam": ("adam", {"sparse": True}),
}
ADAPTIVE = {"adagrad", "adadelta", "rmsprop", "decayed_adagrad", "adamax", "adam", "ftrl",
            "ftrl_power"}


def _model(m, opt_kind, opts):
    """x [8] (+ an is_sparse embedding of ids) -> fc 16 tanh -> fc 1 ->
    squared error, with the case's surfaces."""
    PA = m.ParamAttr
    x = m.layers.data("x", shape=[8])
    y = m.layers.data("y", shape=[1])
    w1 = PA(name="w1",
            gradient_clip=m.optimizer.GradientClipByValue(0.05) if opts.get("param_clip") else None,
            learning_rate=opts.get("param_lr", 1.0),
            update_hooks=[m.param_attr.StaticPruningHook(opts["prune"])] if "prune" in opts
            else None)
    w2 = PA(name="w2", gradient_clip=m.optimizer.GradientClipByNorm(0.1)
            if opts.get("param_clip") else None)
    h = m.layers.fc(x, size=16, act="tanh", param_attr=w1)
    if opts.get("sparse"):
        ids = m.layers.data("ids", shape=[1], dtype=np.int64)
        e = m.layers.embedding(ids, size=[VOCAB, 16], is_sparse=True, param_attr="emb")
        h = m.layers.elementwise_add(h, m.layers.reshape(e, [-1, 16]))
    loss = m.layers.mean(m.layers.square_error_cost(m.layers.fc(h, size=1, param_attr=w2), y))
    kw = {}
    if "schedule" in opts:
        kw["lr_schedule"] = _schedule(m, opts["schedule"])
    clip = opts.get("clip") or ("value" if opts.get("sparse") else None)
    if clip:
        kw["grad_clip"] = {"value": lambda: m.optimizer.GradientClipByValue(0.02, -0.03),
                           "norm": lambda: m.optimizer.GradientClipByNorm(0.05),
                           "global": lambda: m.optimizer.GradientClipByGlobalNorm(0.05)}[clip]()
    if opts.get("sparse"):
        kw["regularization"] = m.regularizer.L2Decay(0.1)
    _opt(m, opt_kind, **kw).minimize(loss)
    avg = m.optimizer.ModelAverage(0.5, min_average_window=2, max_average_window=3) \
        if opts.get("average") else None
    return loss, avg


def _build(m, case):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    kind, opts = CASES[case]
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 3
    with m.program_guard(prog, startup):
        loss, avg = _model(m, kind, opts)
    if opts.get("amp"):
        prog.set_amp(opts["amp"])
    return prog, startup, loss, avg


def _feeds(sparse):
    rng = np.random.RandomState(4)
    out = []
    for _ in range(STEPS):
        f = {"x": rng.randn(BATCH, 8).astype(np.float32),
             "y": rng.randn(BATCH, 1).astype(np.float32)}
        if sparse:  # repeated rows in a batch, and rows no batch touches
            f["ids"] = rng.randint(0, VOCAB // 2, (BATCH, 1)).astype(np.int64)
        out.append(f)
    return out


def _no_excess(f):
    import jax

    jit = jax.jit
    try:
        jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        return f()
    finally:
        jax.jit = jit


def _jax_run(case):
    prog, startup, loss, avg = _build(pt, case)
    exe = pt.Executor()
    exe.run(startup)
    sc = pt.global_scope()
    names = [v.name for v in prog.persistables() if sc.has(v.name)]
    state = {n: np.array(np.asarray(sc.get(n))) for n in names}
    run = (lambda f: exe.run(prog, feed=f, fetch_list=[loss]))
    wrap = _no_excess if CASES[case][1].get("amp") else (lambda f: f())
    losses = [float(wrap(lambda: run(f))[0]) for f in _feeds(CASES[case][1].get("sparse"))]
    after = {n: np.array(np.asarray(sc.get(n))) for n in names}
    averaged = None
    if avg is not None:
        avg.apply(exe)
        averaged = {p.name: np.array(np.asarray(sc.get(p.name))) for p in prog.parameters()}
        avg.restore(exe)
    return prog.to_dict(), state, losses, after, averaged


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax(case, one_thread):
    jdict, state, jlosses, jafter, javg = _jax_run(case)
    prog, _, loss, avg = _build(ptt, case)
    assert prog.to_dict() == jdict
    exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    tio.params_from_numpy(scope, state, "cpu")
    kind, opts = CASES[case]
    losses = [float(exe.run(prog, f, [loss], scope=scope)[0]) for f in _feeds(opts.get("sparse"))]
    tol = TOL[opts.get("amp")]
    np.testing.assert_allclose(losses, jlosses, rtol=tol)
    lr = {"sgd": 0.1, "momentum": 0.05, "adagrad": 0.1, "decayed_adagrad": 0.1,
          "ftrl": 0.1, "ftrl_power": 0.1, "adadelta": 1.0}.get(kind, 0.01)
    slack = LR_SHARE * lr * STEPS if kind in ADAPTIVE else 0.0
    for name, want in jafter.items():
        got = scope.get(name).float().numpy()
        err = float(np.abs(got - want).max()) if want.size else 0.0
        bound = max(tol * max(float(np.abs(want).max()), 1e-3), slack)
        assert got.shape == want.shape and err <= bound, (name, err, bound)
    if "prune" in opts:
        mask = scope.get("w1@PRUNE_MASK")
        assert int((mask == 0).sum()) == round(opts["prune"] * mask.numel())
        assert torch.equal(scope.get("w1") * mask, scope.get("w1"))
    if opts.get("sparse"):  # rows no batch touched stay as the startup made them
        untouched = sorted(set(range(VOCAB)) - {int(i) for f in _feeds(True) for i in f["ids"].ravel()})
        np.testing.assert_array_equal(scope.get("emb").numpy()[untouched],
                                      state["emb"][untouched])
    if avg is not None:
        trained = {p.name: scope.get(p.name) for p in prog.parameters()}
        avg.apply(exe, scope)
        for n, want in javg.items():
            np.testing.assert_allclose(scope.get(n).numpy(), want, rtol=TOL[None], atol=1e-7)
        avg.restore(exe, scope)
        assert all(scope.get(n) is v for n, v in trained.items())


def test_proximal_gd_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator as TOp

    rng = np.random.RandomState(6)
    vals = {"Param": rng.randn(5, 3).astype(np.float32), "Grad": rng.randn(5, 3).astype(np.float32),
            "LearningRate": np.array([0.3], np.float32)}
    slots = {k: [k] for k in vals}
    attrs = {"l1": 0.2, "l2": 0.1}
    jenv = {k: jnp.asarray(v) for k, v in vals.items()}
    tenv = {k: torch.as_tensor(v) for k, v in vals.items()}
    outs = {"ParamOut": ["Param"]}
    jreg.get_kernel("proximal_gd")(jreg.OpContext(JOp("proximal_gd", slots, outs, attrs), jenv))
    treg.get_kernel("proximal_gd")(treg.OpContext(TOp("proximal_gd", slots, outs, attrs), tenv))
    np.testing.assert_allclose(tenv["Param"].numpy(), np.asarray(jenv["Param"]), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------ checkpoints across packages


def _ckpt_build(m):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 8
    with m.program_guard(prog, startup):
        x = m.layers.data("x", shape=[4])
        y = m.layers.data("y", shape=[1])
        loss = m.layers.mean(m.layers.square_error_cost(m.layers.fc(x, size=1), y))
        m.optimizer.RMSProp(learning_rate=0.05, lr_schedule=m.optimizer.ExponentialDecay(
            decay_steps=2, decay_rate=0.7), name="rms").minimize(loss)
    return prog, startup, [x, y], loss


def _ckpt_reader():
    rng = np.random.RandomState(1)
    xs = rng.randn(4 * BATCH, 4).astype(np.float32)
    ys = (xs @ rng.randn(4, 1) + 0.5).astype(np.float32)
    samples = list(zip(xs, ys))
    return ptt.data.batch(lambda: iter(samples), BATCH)


def _trainer(m, d):
    prog, startup, feeds, loss = _ckpt_build(m)
    cfg = m.CheckpointConfig(d, step_interval=3, max_num_checkpoints=10)
    if m is pt:
        t = pt.Trainer(loss, main_program=prog, startup_program=startup, checkpoint_config=cfg)
        get = lambda n: np.asarray(pt.global_scope().get(n))  # noqa: E731
    else:
        t = ptt.Trainer(loss, main_program=prog, startup_program=startup, place="cpu",
                        scope=ptt.Scope(), checkpoint_config=cfg)
        get = lambda n: t.scope.get(n).numpy()  # noqa: E731
    return t, prog, feeds, get


def _train(m, d, state=None):
    t, prog, feeds, get = _trainer(m, d)
    t.init()
    if state is not None:
        for n, v in state.items():
            if m is pt:
                pt.global_scope().set(n, v)
            else:
                t.scope.set(n, torch.as_tensor(v))
    events = []
    t.train(_ckpt_reader(), 2, feed_order=feeds, event_handler=events.append)
    costs = [float(e.cost) for e in events if type(e).__name__ == "EndIteration"]
    return costs, {v.name: np.array(get(v.name)) for v in prog.persistables()}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_rmsprop_schedule_checkpoint_crosses(writer, reader, tmp_path, one_thread):
    """Both packages train 2 passes of 4 batches from the JAX startup's
    state, checkpointing every 3 steps; the writer's run is cut back to
    its step-3 checkpoint (the step counter, the schedule's, and RMSProp's
    mean squares and moments in it) and the reader resumes there: its
    costs from step 4 on and its final state are the uninterrupted runs'."""
    pkgs = {"jax": pt, "port": ptt}
    t, prog, _, get = _trainer(pt, str(tmp_path / "startup"))
    t.init()
    state = {v.name: np.array(get(v.name)) for v in prog.persistables()}
    full = {k: _train(m, str(tmp_path / k), state) for k, m in pkgs.items()}
    np.testing.assert_allclose(full["port"][0], full["jax"][0], rtol=1e-6)
    d = str(tmp_path / "resume")
    shutil.copytree(str(tmp_path / writer), d)
    for s in tio._complete_serials(d):
        with open(os.path.join(tio._serial_dir(d, s), tio.META_FILE)) as f:
            if '"step": 3' not in f.read():
                shutil.rmtree(tio._serial_dir(d, s))
    assert len(tio._complete_serials(d)) == 1
    costs, final = _train(pkgs[reader], d)
    assert len(costs) == 5
    for k in ("jax", "port"):
        np.testing.assert_allclose(costs, full[k][0][3:], rtol=1e-6)
        for n, want in full[k][1].items():
            np.testing.assert_allclose(final[n], want, rtol=1e-6, atol=1e-7, err_msg=n)
    assert final["rms.step"] == 8.0
