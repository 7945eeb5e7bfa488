"""Sparse feed slots (`SparseArray`, `data(..., sparse_format=...)`, the
sparse x dense `mul`) against the JAX package, and through the port's
DataFeeder, windows, Trainer and artifacts.

Tolerances: the padded-COO leaves and feeds are equal; sparse products,
losses and gradients within 1e-5 of each value's scale (its largest
|value|, at least 1e-3) in f32; under bf16 amp the loss and logits within
2e-2 of their scale and each gradient within 2e-2 of the step's largest
gradient (a bias gradient is a cancelling sum of bf16 terms); the sparse fc
against its densified twin (the same weights fed the dense rows) within
1e-5; a window's steps are the per-step loop's bits. Checkpoints and
artifacts cross between the packages within 1e-6 of the scale.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.sparse import SparseArray as JSparse
from paddle_tpu.data.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.core.sparse import SparseArray
from paddle_tpu_torch.data.feeder import DataFeeder, DevicePrefetcher, FeedWindow

from test_torch_ops_general import one_thread  # noqa: F401

DIM, B = 50, 6
TOL = {None: 1e-5, "bfloat16": 2e-2}


def _samples(fmt, seed=0, n=B, dim=DIM):
    """Each sample's nonzeros: 0-5 indices (repeats allowed), or pairs."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        idx = rng.randint(0, dim, rng.randint(0, 6)).tolist()
        out.append(idx if fmt == "binary" else
                   [(i, float(np.float32(rng.randn()))) for i in idx])
    return out


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("fmt", ["binary", "float"])
def test_from_batch_equals_jax(fmt):
    """Leaves, capacity (rounded to the bucket) and the static batch and
    dim equal the JAX package's; padding rowids are `batch`."""
    s = _samples(fmt)
    j = JSparse.from_batch(s, dim=DIM, format=fmt, bucket=8)
    t = SparseArray.from_batch(s, dim=DIM, format=fmt, bucket=8)
    assert (t.batch, t.dim, t.capacity) == (j.batch, j.dim, j.capacity)
    for a, b in zip(t.leaves(), (j.indices, j.values, j.rowids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    nnz = sum(len(x) for x in s)
    assert t.capacity % 8 == 0 and bool((t.rowids[nnz:] == B).all())
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    w = np.random.RandomState(1).randn(DIM, 7).astype(np.float32)
    _close(t.matmul(torch.as_tensor(w)).numpy(), j.matmul(jnp.asarray(w)), 1e-6)
    _close(t.matmul(torch.as_tensor(w)).numpy(), t.to_dense().numpy() @ w, 1e-6)


def test_from_batch_errors():
    for pkg in (JSparse, SparseArray):
        with pytest.raises(ValueError, match="out of range"):
            pkg.from_batch([[1, DIM]], dim=DIM)
        with pytest.raises(ValueError, match="out of range"):
            pkg.from_batch([[(-1, 0.5)]], dim=DIM, format="float")
        with pytest.raises(ValueError, match="exceed capacity"):
            pkg.from_batch([[1, 2, 3]], dim=DIM, capacity=2)
        with pytest.raises(ValueError, match="unknown sparse format"):
            pkg.from_batch([[1]], dim=DIM, format="csr")
    with pytest.raises(ValueError, match="sparse_format"):
        ptt.layers.data("s", shape=[DIM], sparse_format="csr")


def test_matmul_gradient_equals_jax():
    """The weight's gradient through the gather and the segment sum, and
    the padding slots (index 0, value 0) adding nothing."""
    s = SparseArray.from_batch(_samples("float", 3), dim=DIM, format="float", bucket=16)
    js = JSparse.from_batch(_samples("float", 3), dim=DIM, format="float", bucket=16)
    w = np.random.RandomState(2).randn(DIM, 5).astype(np.float32)
    c = np.random.RandomState(3).randn(B, 5).astype(np.float32)
    jg = jax.grad(lambda w: jnp.sum(js.matmul(w) * c))(jnp.asarray(w))
    tw = torch.as_tensor(w).requires_grad_(True)
    (s.matmul(tw) * torch.as_tensor(c)).sum().backward()
    _close(tw.grad.numpy(), jg, 1e-6)


# ------------------------------------------------------------- programs --
def _fresh(m):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    return m.Program(), m.Program()


def _ctr(m, dim=DIM, fmt="binary", dense_twin=False, opt=None):
    """A wide & deep CTR head on one sparse slot: fc(slot -> 1) + fc(slot
    -> 8, relu) joined with 3 dense features; sigmoid CE on the sum."""
    main, startup = _fresh(m)
    startup.random_seed = 5
    L = m.layers
    with m.program_guard(main, startup):
        slot = L.data("slot", shape=[dim], sparse_format=None if dense_twin else fmt)
        dense = L.data("dense", shape=[3])
        label = L.data("label", shape=[1])
        wide = L.fc(slot, size=1, param_attr=m.ParamAttr(name="wide.w"), bias_attr=False)
        deep = L.fc(slot, size=8, act="relu", param_attr=m.ParamAttr(name="deep.w"))
        deep = L.fc(L.concat([deep, dense], axis=1), size=1)
        logit = L.elementwise_add(wide, deep)
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        if opt is not None:
            opt(m).minimize(loss)
    return main, startup, [slot, dense, label], loss, logit


def _batch(seed, fmt="binary", n=B):
    rng = np.random.RandomState(seed + 100)
    return [(s, rng.randn(3).astype(np.float32), np.float32([rng.randint(0, 2)]))
            for s in _samples(fmt, seed, n)]


def _state(main, seed=0):
    rng = np.random.RandomState(seed)
    return {p.name: (0.3 * rng.standard_normal(p.shape)).astype(np.float32)
            for p in main.persistables()}


@pytest.mark.parametrize("amp", [None, "bfloat16"])
@pytest.mark.parametrize("fmt", ["binary", "float"])
def test_sparse_fc_program_equals_jax_and_dense_twin(fmt, amp, one_thread):
    """Both front ends build one dict; DataFeeder gives equal feeds; the
    loss, the logits and every gradient agree with the JAX package, and
    (f32) with the densified twin's."""
    progs = {}
    for m in (pt, ptt):
        main, startup, feeds, loss, logit = _ctr(m, fmt=fmt)
        with m.program_guard(main, startup):
            grads = [g for _, g in m.append_backward(loss)]
        if amp:
            main.set_amp(amp)
        progs[m] = (main, feeds, [loss.name, logit.name] + [g.name for g in grads])
    assert progs[pt][0].to_dict() == progs[ptt][0].to_dict()
    assert progs[ptt][0].global_block().vars["slot"].sparse_format == fmt
    batch = _batch(1, fmt)
    jfeed = JFeeder(progs[pt][1], bucket=16).feed(batch)
    tfeed = DataFeeder(progs[ptt][1], bucket=16).feed(batch)
    assert isinstance(tfeed["slot"], SparseArray)
    for a, b in zip(tfeed["slot"].leaves(), (jfeed["slot"].indices, jfeed["slot"].values,
                                            jfeed["slot"].rowids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    state = _state(progs[ptt][0])
    jscope, tscope = pt.Scope(), ptt.Scope()
    for n, a in state.items():
        jscope.set(n, jnp.asarray(a))
    ptt.io.params_from_numpy(tscope, state, "cpu")
    names = progs[ptt][2]
    j = pt.Executor().run(progs[pt][0], feed=jfeed, fetch_list=names, scope=jscope)
    t = ptt.Executor(device="cpu").run(progs[ptt][0], tfeed, names, scope=tscope)
    if amp:
        # a bias gradient is a cancelling sum of bf16 terms: each gradient
        # is held to the step's largest one (its scale), the forward to its own
        step = max(float(np.abs(np.asarray(a, np.float32)).max()) for a in j[2:])
        for a, b in zip(j[:2], t[:2]):
            _close(b, a, TOL[amp])
        for a, b in zip(j[2:], t[2:]):
            np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                                       rtol=0, atol=TOL[amp] * step)
        return
    for a, b in zip(j, t):
        _close(b, a, TOL[amp])
    main, startup, feeds, loss, logit = _ctr(ptt, fmt=fmt, dense_twin=True)
    with ptt.program_guard(main, startup):
        grads = [g for _, g in ptt.append_backward(loss)]
    dscope = ptt.Scope()
    ptt.io.params_from_numpy(dscope, state, "cpu")
    dfeed = dict(tfeed, slot=tfeed["slot"].to_dense().numpy())
    d = ptt.Executor(device="cpu").run(main, dfeed, [loss.name, logit.name]
                                       + [g.name for g in grads], scope=dscope)
    for a, b in zip(d, t):
        _close(b, a, 1e-5)


def _adam(m):
    return m.optimizer.Adam(learning_rate=0.01)


def test_window_and_prefetcher_take_sparse_feeds(one_thread):
    """DevicePrefetcher(window=3) stacks sparse feeds leaf by leaf; a window
    through Executor.run_window gives the per-step loop's bits;
    FeedWindow.slice gives a step back; the Trainer's scan_window trains
    to the per-step loop's parameters."""
    main, startup, feeds, loss, _ = _ctr(ptt, opt=_adam)
    batches = [_batch(i) for i in range(4)]
    feeder = DataFeeder(feeds, bucket=32)
    wins = list(DevicePrefetcher(lambda: iter(batches), feeder, device="cpu", window=3))
    assert [w.k for w in wins] == [3, 1]
    assert isinstance(wins[0].feed["slot"], SparseArray)
    assert tuple(wins[0].feed["slot"].indices.shape) == (3, 32)
    one = wins[0].slice(1)["slot"]
    np.testing.assert_array_equal(one.values[0].numpy(), feeder.feed(batches[1])["slot"].values)
    exe = ptt.Executor(device="cpu")
    per, win = ptt.Scope(), ptt.Scope()
    exe.run(startup, scope=per, seed=0)
    exe.run(startup, scope=win, seed=0)
    costs = [float(exe.run(main, feeder.feed(b), [loss], scope=per)[0]) for b in batches[:3]]
    ys, _ = exe.run_window(main, wins[0].feed, [loss], scope=win)
    assert [float(c) for c in ys[0]] == costs
    for p in main.parameters():
        assert torch.equal(per.get(p.name), win.get(p.name)), p.name
    results = {}
    for window in (0, 2):
        sc = ptt.Scope()
        tr = ptt.Trainer(loss, main_program=main, startup_program=startup, place="cpu",
                         scope=sc)
        tr.init()
        tr.train(lambda: iter(batches), 1, feed_order=feeds, scan_window=window)
        results[window] = {p.name: sc.get(p.name).clone() for p in main.parameters()}
    for n, v in results[0].items():
        assert torch.equal(v, results[2][n]), n


def test_sparse_program_dict_round_trip():
    main, _, _, _, _ = _ctr(ptt, fmt="float")
    d = main.to_dict()
    back = ptt.Program.from_dict(d)
    assert back.to_dict() == d
    assert back.global_block().vars["slot"].sparse_format == "float"
    assert pt.Program.from_dict(d).to_dict() == d


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sparse_artifact_crosses(tmp_path, writer):
    """A sparse-slot inference artifact saved by either package loads in
    the other: the same logits within 1e-6 of their scale."""
    batch = _batch(4)
    out = {}
    d = str(tmp_path / "art")
    for m in ((ptt, pt) if writer == "port" else (pt, ptt)):
        if m is (ptt if writer == "port" else pt):
            main, startup, feeds, loss, logit = _ctr(m)
            state = _state(main)
            if m is pt:
                scope = pt.Scope()
                for n, a in state.items():
                    scope.set(n, jnp.asarray(a))
                pt.io.save_inference_model(d, ["slot", "dense"], [logit], main_program=main,
                                           scope=scope)
            else:
                scope = ptt.Scope()
                ptt.io.params_from_numpy(scope, state, "cpu")
                ptt.io.save_inference_model(d, ["slot", "dense"], [logit], main_program=main,
                                            scope=scope)
        if m is pt:
            scope = pt.Scope()
            prog, fnames, fetches = pt.io.load_inference_model(d, scope=scope)
            feed = JFeeder([prog.global_block().var(n) for n in fnames], bucket=16).feed(
                [b[:2] for b in batch])
            out[m] = np.asarray(pt.Executor().run(prog, feed=feed, fetch_list=fetches,
                                                  scope=scope)[0])
        else:
            scope = ptt.Scope()
            prog, fnames, fetches = ptt.io.load_inference_model(d, scope=scope, device="cpu")
            feed = DataFeeder([prog.global_block().vars[n] for n in fnames], bucket=16).feed(
                [b[:2] for b in batch])
            out[m] = ptt.Executor(device="cpu").run(prog, feed, fetches, scope=scope)[0]
    assert os.path.exists(os.path.join(d, "meta.json"))
    _close(out[ptt], out[pt], 1e-6)
