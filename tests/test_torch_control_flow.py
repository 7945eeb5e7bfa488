"""While and cond through the port against the JAX package (while_loop and
cond ops, layers/control_flow.py), built by both front ends (equal program
dicts).

- While: sum(0..n-1) for n = 5, 1 and 0 (zero iterations give the entry
  values), exact in int32; a float loop that doubles a vector and adds a
  parameter it closes over until its sum passes a bound, within 1e-6 of
  its scale.
- A While whose output reaches the loss raises in the backward in both
  packages: reverse mode through jax.lax.while_loop raises, and the port
  does not differentiate what the reference cannot.
- cond: the branch the predicate picks, both ways, within 1e-6; three SGD
  steps through a cond whose untaken branch would make NaN, both
  packages from one state: the losses and parameters within 1e-6 of their
  scale in f32, 2e-2 under bf16 amp (the JAX side compiled with XLA's
  excess precision off), the untaken branch's weight unmoved bit for bit
  in the port.
- Inside a CUDA graph capture, both ops raise ControlFlowCaptureError
  (the capture state mocked: the CPU has no graphs).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.ops import control_flow_ops

TOL = 1e-6
TOL_AMP = {None: TOL, "bfloat16": 2e-2}  # bf16: a bf16 ulp at the scale


def _no_excess(f):
    """f() with the JAX side's jit compiled with XLA's excess precision
    off, so that a bf16 program rounds where its ops round."""
    import functools

    import jax

    jit = jax.jit
    try:
        jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        return f()
    finally:
        jax.jit = jit


def _build(m, model):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 5
    with m.program_guard(prog, startup):
        fetch = model(m)
    return prog, startup, fetch


def _sum_first_n(m):
    n = m.layers.data("n", shape=[1], dtype=np.int32, append_batch_size=False)
    i = m.layers.fill_constant([1], np.int32, 0)
    s = m.layers.fill_constant([1], np.int32, 0)
    c = m.layers.less_than(i, n)
    loop = m.layers.While(cond=c)
    with loop.block():
        s2 = m.layers.elementwise_add(s, i)
        i2 = m.layers.increment(i)
        loop.update(i, i2)
        loop.update(s, s2)
        loop.update(c, m.layers.less_than(i2, n))
    i_fin, s_fin, _ = loop()
    return [i_fin, s_fin]


def _doubling(m):
    """v <- 2 v + w (w a parameter the block closes over) while sum(v) <
    bound; then the loss reads the final v."""
    x = m.layers.data("x", shape=[4])
    w = m.layers.fc(x, size=4, bias_attr=False, param_attr="w_loop")
    bound = m.layers.fill_constant([1], np.float32, 50.0)
    v = m.layers.fill_constant([1, 4], np.float32, 0.25)
    c = m.layers.less_than(m.layers.reduce_sum(v, dim=None, keep_dim=True), bound)
    loop = m.layers.While(cond=c)
    with loop.block():
        v2 = m.layers.elementwise_add(m.layers.scale(v, scale=2.0), w)
        loop.update(v, v2)
        loop.update(c, m.layers.less_than(m.layers.reduce_sum(v2, dim=None, keep_dim=True),
                                          bound))
    v_fin, _ = loop()
    return [v_fin, m.layers.mean(v_fin)]


def _feeds(model):
    if model is _sum_first_n:
        return [{"n": np.array([k], np.int32)} for k in (5, 1, 0)]
    return [{"x": np.random.RandomState(2).rand(1, 4).astype(np.float32) * 0.1}]


def _jax_state(prog, startup):
    exe = pt.Executor()
    exe.run(startup)
    sc = pt.global_scope()
    return exe, {v.name: np.array(np.asarray(sc.get(v.name)))
                 for v in prog.persistables() if sc.has(v.name)}


@pytest.mark.parametrize("model", [_sum_first_n, _doubling], ids=["sum_first_n", "doubling"])
def test_while_matches_jax(model):
    jprog, jstart, jfetch = _build(pt, model)
    jexe, state = _jax_state(jprog, jstart)
    tprog, _, tfetch = _build(ptt, model)
    assert tprog.to_dict() == jprog.to_dict()
    texe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    tio.params_from_numpy(scope, state, "cpu")
    for feed in _feeds(model):
        want = jexe.run(jprog, feed=feed, fetch_list=jfetch)
        got = texe.run(tprog, feed, tfetch, scope=scope)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * np.abs(w).max())
    if model is _sum_first_n:
        assert [int(texe.run(tprog, f, tfetch, scope=scope)[1][0]) for f in _feeds(model)] \
            == [10, 0, 0]


def test_while_under_autodiff_raises_in_both():
    """The loss of the doubling loop reaches w_loop through the While."""
    for m in (pt, ptt):
        prog, startup, (_, loss) = _build(m, _doubling)
        with m.program_guard(prog, startup):
            m.optimizer.SGD(learning_rate=0.1).minimize(loss)
        feed = _feeds(_doubling)[0]
        if m is pt:
            exe = pt.Executor()
            exe.run(startup)
            with pytest.raises(Exception, match="[Rr]everse-mode differentiation"):
                exe.run(prog, feed=feed, fetch_list=[loss])
        else:
            exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
            exe.run(startup, scope=scope)
            with pytest.raises(RuntimeError, match="Reverse-mode differentiation does not "
                                                   "work for while_loop"):
                exe.run(prog, feed, [loss], scope=scope)


def _branches(m):
    x = m.layers.data("x", shape=[1, 2], append_batch_size=False)
    p = m.layers.data("p", shape=[1], dtype=np.bool_, append_batch_size=False)
    return [m.layers.cond(p, lambda: m.layers.scale(x, scale=2.0),
                          lambda: m.layers.scale(x, scale=-1.0))]


def _cond_train(m):
    """The JAX package's tests/test_control_flow.py:62 program, its false
    branch 0/0 (NaN) were it taken."""
    x = m.layers.data("x", shape=[4])
    p = m.layers.data("p", shape=[1], dtype=np.bool_, append_batch_size=False)
    y = m.layers.data("y", shape=[1])
    h1 = m.layers.fc(x, size=1, param_attr="w_true")
    h2 = m.layers.fc(x, size=1, param_attr="w_false")
    out = m.layers.cond(p, lambda: m.layers.scale(h1, 1.0),
                        lambda: m.layers.elementwise_div(m.layers.scale(h2, 0.0),
                                                         m.layers.scale(h2, 0.0)))
    loss = m.layers.mean(m.layers.square_error_cost(out, y))
    m.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss]


def test_cond_matches_jax():
    jprog, _, jfetch = _build(pt, _branches)
    tprog, _, tfetch = _build(ptt, _branches)
    assert tprog.to_dict() == jprog.to_dict()
    xv = np.array([[1.0, 3.0]], np.float32)
    jexe, texe = pt.Executor(), ptt.Executor(device="cpu")
    for pv, want in ((True, 2 * xv), (False, -xv)):
        feed = {"x": xv, "p": np.array([pv])}
        (j,) = jexe.run(jprog, feed=feed, fetch_list=jfetch)
        (t,) = texe.run(tprog, feed, tfetch, scope=ptt.Scope())
        np.testing.assert_array_equal(t, want)
        np.testing.assert_allclose(t, np.asarray(j), rtol=TOL)


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_cond_trains_only_the_taken_branch(amp):
    jprog, jstart, jfetch = _build(pt, _cond_train)
    jexe, state = _jax_state(jprog, jstart)
    tprog, _, tfetch = _build(ptt, _cond_train)
    assert tprog.to_dict() == jprog.to_dict()
    tol = TOL_AMP[amp]
    if amp:
        jprog.set_amp(amp)
        tprog.set_amp(amp)
    texe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    tio.params_from_numpy(scope, state, "cpu")
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 4).astype(np.float32), "y": rng.randn(8, 1).astype(np.float32),
            "p": np.array([True])}
    for _ in range(3):
        (j,) = _no_excess(lambda: jexe.run(jprog, feed=feed, fetch_list=jfetch))
        (t,) = texe.run(tprog, feed, tfetch, scope=scope)
        assert np.isfinite(t) and abs(float(t) - float(j)) <= tol * max(1.0, abs(float(j)))
    sc = pt.global_scope()
    for p in tprog.parameters():
        want = np.asarray(sc.get(p.name))
        got = scope.get(p.name).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(scope.get("w_false").numpy(), state["w_false"])
    assert not np.array_equal(scope.get("w_true").numpy(), state["w_true"])


class _OnCard:
    """A stand-in for a card tensor (the CPU has no graphs to capture)."""

    is_cuda = True


@pytest.mark.parametrize("op_type", ["while_loop", "cond"])
def test_host_read_under_capture_raises(op_type, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(control_flow_ops.ControlFlowCaptureError, match=op_type):
        control_flow_ops._host_bool(op_type, _OnCard())
    # a CPU tensor is never captured: the read goes on
    assert control_flow_ops._host_bool(op_type, torch.tensor([True]))
