"""The general ops, their layers and networks.py against the JAX package.

Each op runs through both packages' OpContexts on the same numpy inputs
(dense, and ragged where the op keeps a LoD), in f32 and under bf16 amp.
Tolerances: f32 within 1e-5 of each output's scale (the largest |value|,
at least 1); bf16 outputs within 2e-2 of it, a bf16 ulp at that scale,
since XLA on the CPU may keep an f32 intermediate where torch rounds. Integer
and bool outputs are equal. The layers' programs are built by both front
ends (the same dict), their gradients held port against JAX at 1e-5 of
each gradient's scale in f32; the nine networks.py builders the same, on
the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import networks as jnets
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu_torch import networks as tnets
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lod import LoDArray as TLoD
from paddle_tpu_torch.core.program import Operator as TOp

TOL = {None: 1e-5, "bfloat16": 2e-2}
AMP = [None, "bfloat16"]
LENS = (5, 1, 7, 3)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Lod:
    """Ragged rows given as numpy sequences."""

    def __init__(self, seqs):
        self.seqs = seqs

    def jax(self):
        return JLoD.from_sequences(self.seqs, capacity=32)

    def torch(self):
        return TLoD.from_sequences(self.seqs, capacity=32)


def _jval(v):
    return v.jax() if isinstance(v, Lod) else jnp.asarray(v)


def _tval(v):
    if isinstance(v, Lod):
        return v.torch()
    if v.dtype == jnp.bfloat16:  # numpy's bf16 (ml_dtypes) widens exactly
        return torch.as_tensor(v.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(v)


def run_both(op_type, inputs, attrs=None, amp=None, outs=(("Out", 1),)):
    """One op in both packages: {slot: [(jax value, port value), ...]}."""
    slots = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in inputs.items()}
    jenv, tenv = {"@AMP@": amp}, {"@AMP@": amp}
    for k, vals in inputs.items():
        for name, v in zip(slots[k], vals):
            jenv[name], tenv[name] = _jval(v), _tval(v)
    out_names = {slot: [f"{slot}_out{i}" for i in range(n)] for slot, n in outs}
    attrs = dict(attrs or {})
    jreg.get_kernel(op_type)(jreg.OpContext(JOp(op_type, slots, out_names, attrs), jenv))
    treg.get_kernel(op_type)(treg.OpContext(TOp(op_type, slots, out_names, attrs), tenv))
    return {slot: [(jenv[n], tenv[n]) for n in names] for slot, names in out_names.items()}


def assert_same(j, t, tol):
    """Dtype equal; values within tol of the output's scale (ints and bools
    equal); a LoD output's lod equal too."""
    if isinstance(t, TLoD):
        assert isinstance(j, JLoD)
        np.testing.assert_array_equal(t.seq_ids.numpy(), np.asarray(j.seq_ids))
        j, t = j.data, t.data
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    assert tuple(t.shape) == tuple(j.shape)
    jn = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
    tn = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if not np.issubdtype(jn.dtype, np.floating):
        np.testing.assert_array_equal(tn, jn)
        return
    finite = np.isfinite(jn)
    np.testing.assert_array_equal(np.isfinite(tn), finite)
    scale = max(1.0, float(np.abs(jn[finite]).max()) if finite.any() else 1.0)
    np.testing.assert_allclose(tn[finite], jn[finite], rtol=0, atol=tol * scale)


def _x(rng, shape, positive=False, lod=False, scale=1.5):
    def draw(s):
        a = (scale * rng.standard_normal(s)).astype(np.float32)
        return np.abs(a) + 0.25 if positive else a

    if lod:
        return Lod([draw((n,) + tuple(shape[1:])) for n in LENS])
    return draw(shape)


# ------------------------------------------------------------ activations --
POSITIVE = {"sqrt", "log", "reciprocal", "pow"}
ACTIVATIONS = ["logsigmoid", "exp", "exponential", "tanh_shrink", "softshrink", "sqrt", "abs",
               "ceil", "floor", "round", "reciprocal", "log", "square", "softplus", "softsign",
               "brelu", "leaky_relu", "soft_relu", "softrelu", "elu", "relu6", "pow", "stanh",
               "hard_shrink", "thresholded_relu", "hard_sigmoid", "swish",
               "softmax_activation"]
# non-default attributes, where the op takes any
ATTRS = {"softshrink": {"lambda": 0.3}, "brelu": {"t_min": -0.5, "t_max": 1.0},
         "leaky_relu": {"alpha": 0.1}, "soft_relu": {"threshold": 1.5}, "elu": {"alpha": 0.7},
         "relu6": {"threshold": 2.0}, "pow": {"factor": 2.5},
         "stanh": {"scale_a": 1.1, "scale_b": 0.4}, "hard_shrink": {"threshold": 0.8},
         "thresholded_relu": {"threshold": 0.4}, "hard_sigmoid": {"slope": 0.3, "offset": 0.4},
         "swish": {"beta": 1.7}}


@pytest.mark.parametrize("amp", AMP)
@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activation_ops(act, lod, amp):
    rng = np.random.RandomState(len(act))
    x = _x(rng, (6, 17), positive=act in POSITIVE, lod=lod)
    if amp:  # an activation under amp sees the bf16 output of a product
        x = x if lod else x.astype(jnp.bfloat16)
    for attrs in ({}, ATTRS.get(act)):
        if attrs is None:
            continue
        (j, t), = run_both(act, {"X": [x]}, attrs, amp)["Out"]
        assert_same(j, t, TOL[amp] if (amp and not lod) else 1e-5)


@pytest.mark.parametrize("act", ["leaky_relu", "elu", "softplus", "swish", "brelu", "stanh"])
def test_act_on_a_layer(act, one_thread):
    """`act=` on fc reaches apply_activation with the op's defaults."""
    def build(pkg):
        x = pkg.layers.data("x", shape=[8])
        return pkg.layers.fc(x, size=5, act=act)

    feed = {"x": np.random.RandomState(1).standard_normal((4, 8)).astype(np.float32)}
    j, t = forward_both(build, feed)
    assert_same(jnp.asarray(j[0]), torch.as_tensor(t[0]), 1e-5)


def test_unknown_activation_raises():
    from paddle_tpu_torch.ops.activation_ops import apply_activation

    with pytest.raises(NotImplementedError, match="unknown activation"):
        apply_activation(torch.zeros(2), "no_such_act")


# ----------------------------------------------------------- math family --
@pytest.mark.parametrize("amp", AMP)
@pytest.mark.parametrize("form", ["same", "axis1", "lod"])
@pytest.mark.parametrize("op", ["elementwise_sub", "elementwise_mul", "elementwise_div",
                                "elementwise_max", "elementwise_min", "elementwise_pow"])
def test_elementwise_ops(op, form, amp):
    rng = np.random.RandomState(3)
    pos = op == "elementwise_pow"
    if form == "lod":
        x, y, attrs = _x(rng, (1, 6), pos, lod=True), _x(rng, (6,), pos), {"axis": -1}
    elif form == "axis1":
        x, y, attrs = _x(rng, (4, 5, 6), pos), _x(rng, (5,), pos), {"axis": 1}
    else:
        x, y, attrs = _x(rng, (4, 6), pos), _x(rng, (4, 6), pos), {}
    if op == "elementwise_div":
        y = np.sign(y) * (np.abs(y) + 0.5)
    if amp and form != "lod":
        x = x.astype(jnp.bfloat16)  # an amp activation meeting an f32 operand
    (j, t), = run_both(op, {"X": [x], "Y": [y]}, attrs, amp)["Out"]
    assert_same(j, t, TOL[amp] if amp and form != "lod" else 1e-5)


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dim", [0, 1, 2, -1, [0, 2], "all", "default"])
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min"])
def test_reduce_ops(op, dim, keep):
    rng = np.random.RandomState(4)
    x = _x(rng, (3, 4, 5))
    attrs = {"keep_dim": keep}
    if dim == "all":
        attrs.update(reduce_all=True, dim=None)
    elif dim != "default":
        attrs["dim"] = dim
    for xv in (x, x.astype(jnp.bfloat16)):
        (j, t), = run_both(op, {"X": [xv]}, attrs)["Out"]
        assert_same(j, t, 1e-5 if xv.dtype == np.float32 else 2e-2)


@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_reduce_sum_of_ints(dtype):
    x = (np.random.RandomState(5).randint(-3, 4, (4, 6)) > 0).astype(dtype)
    for attrs in ({"dim": 1}, {"reduce_all": True}):
        (j, t), = run_both("reduce_sum", {"X": [x]}, attrs)["Out"]
        assert_same(j, t, 0)
    (j, t), = run_both("reduce_mean", {"X": [x.astype(np.int32)]}, {"dim": 0})["Out"]
    assert_same(j, t, 1e-6)


def test_reduce_on_lod_input():
    x = _x(np.random.RandomState(6), (1, 6), lod=True)
    (j, t), = run_both("reduce_sum", {"X": [x]}, {"dim": 1})["Out"]
    assert_same(j, t, 1e-5)


@pytest.mark.parametrize("amp", AMP)
def test_shape_ops(amp):
    rng = np.random.RandomState(7)
    x = _x(rng, (4, 6, 3))
    if amp:
        x = x.astype(jnp.bfloat16)
    cases = [("transpose", {"axis": [2, 0, 1]}, 1),
             ("split", {"num": 3, "axis": 1}, 3),
             ("split", {"sections": [1, 2, 3], "axis": 1}, 3),
             ("split", {"sections": [3, 1], "axis": 0}, 2),
             ("expand", {"expand_times": [2, 1, 3]}, 1),
             ("expand", {"expand_times": [2, 3]}, 1),
             ("slice", {"axes": [0, 2], "starts": [1, 0], "ends": [3, 99]}, 1),
             ("slice", {"axes": [1], "starts": [-4], "ends": [-1]}, 1),
             ("clip", {"min": -0.5, "max": 0.7}, 1),
             ("clip_by_norm", {"max_norm": 1.0}, 1),
             ("clip_by_norm", {"max_norm": 1e3}, 1),
             ("squared_l2_norm", {}, 1),
             ("assign", {}, 1),
             ("argmax", {"axis": 1}, 1),
             ("argmax", {}, 1)]
    for op, attrs, n in cases:
        for j, t in run_both(op, {"X": [x]}, attrs, amp, outs=(("Out", n),))["Out"]:
            assert_same(j, t, TOL[amp])


@pytest.mark.parametrize("src,dst", [("float32", "int32"), ("float32", "bfloat16"),
                                     ("int32", "float32"), ("float32", "bool"),
                                     ("bool", "float32"), ("bfloat16", "float32")])
def test_cast(src, dst):
    x = np.random.RandomState(8).standard_normal((5, 4)).astype(np.float32) * 3
    xv = x.astype(jnp.bfloat16) if src == "bfloat16" else x.astype(src)
    for v in (xv, Lod([xv[:2], xv[2:]]) if src != "bfloat16" else xv):
        (j, t), = run_both("cast", {"X": [v]}, {"dtype": dst})["Out"]
        assert_same(j, t, 0)


def test_increment_keeps_the_counter_dtype():
    for x, step in ((np.array([3], np.int32), 1.0), (np.array([3], np.int32), 2.7),
                    (np.array([0.5], np.float32), 0.25),
                    (np.array([1.0], np.float32).astype(jnp.bfloat16), 0.1)):
        (j, t), = run_both("increment", {"X": [x]}, {"step": step})["Out"]
        assert_same(j, t, 0)
    x = _x(np.random.RandomState(9), (1, 3), lod=True)
    (j, t), = run_both("increment", {"X": [x]}, {"step": 1.5})["Out"]
    assert_same(j, t, 0)


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than", "greater_equal",
                                "equal", "not_equal", "logical_and"])
def test_comparison_ops(op):
    rng = np.random.RandomState(10)
    if op == "logical_and":
        x, y = rng.rand(4, 6) > 0.5, rng.rand(4, 6) > 0.5
    else:  # ties included
        x = rng.randint(-2, 3, (4, 6)).astype(np.float32)
        y = rng.randint(-2, 3, (4, 6)).astype(np.float32)
    for yv in (y, y[:1], y[0, :1]):  # numpy broadcasting
        (j, t), = run_both(op, {"X": [x], "Y": [yv]})["Out"]
        assert_same(j, t, 0)
    xl = Lod([x[:3], x[3:]])
    (j, t), = run_both(op, {"X": [xl], "Y": [y[0]]})["Out"]
    assert_same(j, t, 0)


def test_logical_not():
    x = np.random.RandomState(11).rand(4, 6) > 0.5
    for v in (x, Lod([x[:1], x[1:]])):
        (j, t), = run_both("logical_not", {"X": [v]})["Out"]
        assert_same(j, t, 0)


def test_truncated_gaussian_random():
    """The port draws its own numbers: the same shape, dtype and law (mean
    + std·z, z truncated to [-2, 2])."""
    ctx_env = {"@RNG@": torch.Generator().manual_seed(0)}
    op = TOp("truncated_gaussian_random", {}, {"Out": ["o"]},
             {"shape": [20000], "mean": 1.0, "std": 0.5, "dtype": "float32"})
    treg.get_kernel(op.type)(treg.OpContext(op, ctx_env))
    o = ctx_env["o"].numpy()
    assert o.dtype == np.float32 and o.shape == (20000,)
    assert o.min() >= 0.0 and o.max() <= 2.0
    # the truncated law's mean is 1.0, its std 0.5 * 0.8796
    assert abs(o.mean() - 1.0) < 0.01 and abs(o.std() - 0.5 * 0.8796) < 0.01


# ------------------------------------------------------------------- nn ---
@pytest.mark.parametrize("amp", AMP)
@pytest.mark.parametrize("stride,pad,bias", [(1, 0, True), (2, 1, True), (2, 0, False),
                                             ((2, 1), (1, 0), True)])
def test_conv2d_transpose_op(stride, pad, bias, amp):
    """Against paddle_tpu/ops/nn_ops.py:74; the Filter [in_c, out_c, kh, kw]
    crosses as it lies."""
    rng = np.random.RandomState(12)
    ins = {"Input": [_x(rng, (2, 3, 5, 4), scale=1.0)],
           "Filter": [_x(rng, (3, 4, 3, 3), scale=0.3)]}
    if bias:
        ins["Bias"] = [_x(rng, (4,), scale=0.3)]
    (j, t), = run_both("conv2d_transpose", ins, {"strides": stride, "paddings": pad}, amp,
                       outs=(("Output", 1),))["Output"]
    assert_same(j, t, TOL[amp])


@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_op(soft):
    rng = np.random.RandomState(13)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    x = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if soft:
        lbl = rng.rand(6, 5).astype(np.float32)
        lbl /= lbl.sum(-1, keepdims=True)
    else:
        lbl = rng.randint(0, 5, (6, 1)).astype(np.int32)
    (j, t), = run_both("cross_entropy", {"X": [x], "Label": [lbl]}, {"soft_label": soft},
                       outs=(("Y", 1),))["Y"]
    assert_same(j, t, 1e-5)


@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
@pytest.mark.parametrize("amp", AMP)
def test_softmax_with_cross_entropy_soft_label(amp, lod):
    rng = np.random.RandomState(14)
    lbl = rng.rand(16, 5).astype(np.float32)
    lbl /= lbl.sum(-1, keepdims=True)
    x = rng.standard_normal((16, 5)).astype(np.float32)
    if lod:
        x, lbl = Lod([x[:9], x[9:]]), Lod([lbl[:9], lbl[9:]])
    elif amp:
        x = x.astype(jnp.bfloat16)
    outs = run_both("softmax_with_cross_entropy", {"Logits": [x], "Label": [lbl]},
                    {"soft_label": True}, amp, outs=(("Loss", 1), ("Softmax", 1)))
    for slot in ("Loss", "Softmax"):
        (j, t), = outs[slot]
        assert_same(j, t, 1e-5)


@pytest.mark.parametrize("delta", [1.0, 0.3])
def test_huber_loss_op(delta):
    rng = np.random.RandomState(15)
    x, y = _x(rng, (8, 1)), _x(rng, (8, 1))
    (j, t), = run_both("huber_loss", {"X": [x], "Y": [y]}, {"delta": delta})["Out"]
    assert_same(j, t, 1e-5)


@pytest.mark.parametrize("amp", AMP)
@pytest.mark.parametrize("length,start,bias", [(3, -1, True), (4, -2, False), (2, 0, True),
                                               (5, -4, True)])
def test_sequence_conv_op(length, start, bias, amp):
    rng = np.random.RandomState(16)
    x = _x(rng, (1, 6), lod=True)
    ins = {"X": [x], "Filter": [_x(rng, (length * 6, 7), scale=0.3)]}
    if bias:
        ins["Bias"] = [_x(rng, (7,), scale=0.3)]
    (j, t), = run_both("sequence_conv", ins, {"context_length": length, "context_start": start},
                       amp)["Out"]
    assert_same(j, t, 1e-5)


# -------------------------------------------- programs: layers and grads --
def fresh(pkg):
    if pkg is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    return pkg.Program(), pkg.Program()


def weights(program, seed=0):
    """Seeded values for every persistable (a running variance positive)."""
    rng = np.random.RandomState(seed)
    out = {}
    for p in program.persistables():
        a = (0.4 * rng.standard_normal(p.shape)).astype(np.float32)
        out[p.name] = np.abs(a) + 0.5 if p.name.endswith(".variance") else a
    return out


def forward_both(build, feed, amp=None, grads=False):
    """build(pkg) -> a Variable or a list, under each package's front end
    from names counted from 0: the same program dict, then (jax fetches,
    port fetches) on the same weights; with `grads`, the fetches are the
    loss and every parameter's gradient."""
    progs = {}
    for pkg in (pt, ptt):
        main, startup = fresh(pkg)
        with pkg.program_guard(main, startup):
            outs = build(pkg)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            if grads:
                pgs = pkg.append_backward(outs[0])
                outs = outs[:1] + [g for _, g in pgs]
        if amp:
            main.set_amp(amp)
        progs[pkg] = (main, [o.name for o in outs])
    jm, names = progs[pt]
    pm, pnames = progs[ptt]
    assert pnames == names
    assert pm.to_dict() == jm.to_dict()
    w = weights(pm)
    jscope, pscope = pt.Scope(), ptt.Scope()
    for n, a in w.items():
        jscope.set(n, jnp.asarray(a))
    ptt.io.params_from_numpy(pscope, w, "cpu")
    jfeed = {k: (JLoD.from_sequences(v.seqs, capacity=32) if isinstance(v, Lod) else v)
             for k, v in feed.items()}
    tfeed = {k: (TLoD.from_sequences(v.seqs, capacity=32) if isinstance(v, Lod) else v)
             for k, v in feed.items()}
    j = pt.Executor().run(jm, feed=jfeed, fetch_list=names, scope=jscope)
    t = ptt.Executor(device="cpu").run(pm, tfeed, names, scope=pscope)
    return j, t


def _pre(pkg, n=3, d=6):
    x = pkg.layers.data("x", shape=[d])
    return pkg.layers.fc(x, size=d)


def _scalar(pkg, v):
    return pkg.layers.mean(pkg.layers.elementwise_mul(v, v))


def _lbl_data(pkg):
    return pkg.layers.data("lbl", shape=[1], dtype=np.int32)


# the builders of tests/test_layer_grad_sweep.py for the new layers, written
# once for either package
GRAD_CASES = {
    "sigmoid": lambda m: _scalar(m, m.layers.sigmoid(_pre(m))),
    "tanh": lambda m: _scalar(m, m.layers.tanh(_pre(m))),
    "clip": lambda m: _scalar(m, m.layers.clip(_pre(m), min=-0.3, max=0.3)),
    "reduce_mean": lambda m: _scalar(m, m.layers.reduce_mean(_pre(m), dim=1)),
    "reduce_sum": lambda m: _scalar(m, m.layers.reduce_sum(_pre(m), dim=0)),
    "transpose": lambda m: _scalar(m, m.layers.transpose(_pre(m), perm=(1, 0))),
    "expand": lambda m: _scalar(m, m.layers.expand(_pre(m), expand_times=(2, 3))),
    "split": lambda m: _scalar(m, m.layers.elementwise_sub(*m.layers.split(_pre(m), 2, dim=1))),
    "elementwise_sub": lambda m: _scalar(m, m.layers.elementwise_sub(
        _pre(m), m.layers.tanh(_pre(m)))),
    "elementwise_mul": lambda m: (lambda h: _scalar(m, m.layers.elementwise_mul(
        h, m.layers.sigmoid(h))))(_pre(m)),
    "elementwise_div": lambda m: (lambda h: _scalar(m, m.layers.elementwise_div(
        h, m.layers.scale(m.layers.sigmoid(h), bias=0.5))))(_pre(m)),
    "matmul": lambda m: (lambda h: _scalar(m, m.layers.matmul(h, h, transpose_y=True)))(
        _pre(m)),
    "topk": lambda m: _scalar(m, m.layers.topk(_pre(m), k=6)[0]),
    "cross_entropy": lambda m: _scalar(m, m.layers.cross_entropy(
        m.layers.softmax(_pre(m, d=5)), _lbl_data(m))),
    "conv2d_transpose": lambda m: _scalar(m, m.layers.conv2d_transpose(
        m.layers.data("img", shape=[2, 4, 4]), num_filters=2, filter_size=3, stride=2,
        padding=1)),
    "sequence_conv": lambda m: _scalar(m, m.layers.sequence_pool(m.layers.sequence_conv(
        m.layers.embedding(m.layers.data("ids", shape=[-1], dtype=np.int32, lod_level=1,
                                         append_batch_size=False), size=[11, 6]),
        num_filters=4, filter_size=3), "sum")),
}


def grad_feed(name):
    rng = np.random.RandomState(0)
    feed = {"x": (0.5 * rng.standard_normal((3, 6))).astype(np.float32)}
    if name == "cross_entropy":
        feed = {"x": (0.5 * rng.standard_normal((3, 5))).astype(np.float32),
                "lbl": np.array([[0], [3], [2]], np.int32)}
    elif name == "conv2d_transpose":
        feed = {"img": (0.5 * rng.standard_normal((2, 2, 4, 4))).astype(np.float32)}
    elif name == "sequence_conv":
        feed = {"ids": Lod([rng.randint(0, 11, (n,)).astype(np.int32) for n in (4, 2)])}
    return feed


@pytest.mark.parametrize("amp", AMP)
@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_layer_gradients_match_jax(name, amp, one_thread):
    j, t = forward_both(GRAD_CASES[name], grad_feed(name), amp=amp, grads=True)
    tol = TOL[amp]
    for a, b in zip(j, t):
        a = np.asarray(a, np.float32)
        scale = max(1e-3, float(np.abs(a).max()))
        np.testing.assert_allclose(np.asarray(b, np.float32), a, rtol=0, atol=tol * scale)


NO_GRAD_CASES = {
    "cast": lambda m: m.layers.cast(m.layers.data("x", shape=[6]), "int32"),
    "fill_constant": lambda m: m.layers.elementwise_add(
        m.layers.data("x", shape=[6], append_batch_size=False),
        m.layers.fill_constant([6], "float32", 0.5)),
    "increment": lambda m: m.layers.increment(m.layers.data("x", shape=[6]), 2.0),
    "argmax": lambda m: m.layers.argmax(m.layers.data("x", shape=[6])),
    "less_than": lambda m: m.layers.less_than(m.layers.data("x", shape=[6]),
                                              m.layers.data("y", shape=[6])),
    "less_equal": lambda m: m.layers.less_equal(m.layers.data("x", shape=[6]),
                                                m.layers.data("y", shape=[6])),
    "greater_than": lambda m: m.layers.greater_than(m.layers.data("x", shape=[6]),
                                                    m.layers.data("y", shape=[6])),
    "greater_equal": lambda m: m.layers.greater_equal(m.layers.data("x", shape=[6]),
                                                      m.layers.data("y", shape=[6])),
    "equal": lambda m: m.layers.equal(m.layers.data("x", shape=[6]),
                                      m.layers.data("y", shape=[6])),
    "not_equal": lambda m: m.layers.not_equal(m.layers.data("x", shape=[6]),
                                              m.layers.data("y", shape=[6])),
    "logical_and": lambda m: m.layers.logical_and(
        m.layers.less_than(m.layers.data("x", shape=[6]), m.layers.data("y", shape=[6])),
        m.layers.greater_than(m.layers.data("x", shape=[6]), m.layers.data("y", shape=[6]))),
    "logical_not": lambda m: m.layers.logical_not(m.layers.equal(
        m.layers.data("x", shape=[6]), m.layers.data("y", shape=[6]))),
}


@pytest.mark.parametrize("name", sorted(NO_GRAD_CASES))
def test_layer_programs_without_gradient(name):
    rng = np.random.RandomState(1)
    feed = {"x": rng.randint(-2, 3, (3, 6)).astype(np.float32) * 1.3,
            "y": rng.randint(-2, 3, (3, 6)).astype(np.float32) * 1.3}
    if name == "fill_constant":
        feed = {"x": feed["x"][0]}
    j, t = forward_both(NO_GRAD_CASES[name], feed)
    assert t[0].dtype == np.asarray(j[0]).dtype
    np.testing.assert_array_equal(t[0], np.asarray(j[0]))


def test_every_new_layer_has_a_case():
    assert set(GRAD_CASES) | set(NO_GRAD_CASES) >= {
        "conv2d_transpose", "cross_entropy", "sigmoid", "tanh", "elementwise_sub",
        "elementwise_mul", "elementwise_div", "cast", "fill_constant", "increment",
        "transpose", "matmul", "clip", "reduce_sum", "reduce_mean", "split", "expand", "topk",
        "argmax", "less_than", "less_equal", "greater_than", "greater_equal", "equal",
        "not_equal", "logical_and", "logical_not", "sequence_conv"}
    for name in GRAD_CASES:
        assert name in ptt.layers.__all__
    assert set(jnets.__all__) == set(tnets.__all__)


# --------------------------------------------------------------- networks --
def _ids(pkg):
    x = pkg.layers.data("ids", shape=[-1, 1], dtype=np.int32, lod_level=1,
                        append_batch_size=False)
    return pkg.layers.embedding(x, size=[20, 6])


def _nets(pkg):
    return jnets if pkg is pt else tnets


NETWORKS = {
    "simple_img_conv_pool": lambda m: _nets(m).simple_img_conv_pool(
        m.layers.data("img", shape=[1, 12, 12]), num_filters=4, filter_size=5, pool_size=2),
    "img_conv_group": lambda m: _nets(m).img_conv_group(
        m.layers.data("img", shape=[3, 8, 8]), conv_num_filter=[4, 4],
        conv_with_batchnorm=True, is_test=True),
    "sequence_conv_pool": lambda m: _nets(m).sequence_conv_pool(_ids(m), num_filters=7,
                                                                filter_size=3),
    "text_conv_pool": lambda m: _nets(m).text_conv_pool(_ids(m), num_filters=5, filter_size=4,
                                                        pool_type="average"),
    "simple_lstm": lambda m: m.layers.sequence_pool(_nets(m).simple_lstm(_ids(m), size=5),
                                                    "max"),
    "simple_gru": lambda m: m.layers.sequence_pool(
        _nets(m).simple_gru(_ids(m), size=5, reverse=True), "sum"),
    "bidirectional_lstm": lambda m: m.layers.sequence_pool(
        _nets(m).bidirectional_lstm(_ids(m), size=5), "max"),
    "bidirectional_gru": lambda m: m.layers.sequence_pool(
        _nets(m).bidirectional_gru(_ids(m), size=5), "max"),
    "glu": lambda m: _nets(m).glu(m.layers.data("x", shape=[8]), dim=-1),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_networks_match_jax(name, one_thread):
    """Each builder in both packages: the same program, outputs within 1e-5
    of their scale, and the gradients of a loss on them the same."""
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, 20, (n, 1)).astype(np.int32) for n in (3, 1, 5)]
    feed = {"img": rng.standard_normal((2, 1, 12, 12)).astype(np.float32),
            "x": rng.standard_normal((3, 8)).astype(np.float32), "ids": Lod(seqs)}
    if name == "img_conv_group":
        feed["img"] = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    j, t = forward_both(NETWORKS[name], feed)
    assert_same(jnp.asarray(j[0]), torch.as_tensor(t[0]), 1e-5)
    if name in ("img_conv_group", "glu"):
        return  # img_conv_group in test mode; glu has no parameter
    j, t = forward_both(lambda m: _scalar(m, NETWORKS[name](m)), feed, grads=True)
    for a, b in zip(j, t):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * max(1e-3, float(np.abs(a).max())))


def test_networks_shapes_as_the_reference():
    """tests/test_networks.py's shapes: the pooled bi-LSTM is 2·hidden wide,
    the conv pool num_filters; glu halves the features."""
    feed = {"ids": Lod([np.array([[1], [2], [3]], np.int32), np.array([[4]], np.int32)]),
            "x": np.random.RandomState(0).randn(3, 8).astype(np.float32)}

    def build(m):
        emb = _ids(m)
        bi = m.layers.sequence_pool(_nets(m).bidirectional_lstm(emb, size=5), "max")
        return [bi, _nets(m).sequence_conv_pool(emb, num_filters=7, filter_size=3),
                _nets(m).glu(m.layers.data("x", shape=[8]))]

    j, t = forward_both(build, feed)
    assert t[0].shape[1] == 10 and t[1].shape[1] == 7 and t[2].shape == (3, 4)
    a, b = feed["x"][:, :4], feed["x"][:, 4:]
    np.testing.assert_allclose(t[2], a / (1 + np.exp(-b)), rtol=1e-5)


def test_jax_compiles_cpu_only():
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("kind", ["bidirectional_lstm", "bidirectional_gru"])
def test_network_max_len_bounds_the_recurrence(kind, one_thread):
    """The port's RNN builders take dynamic_lstm/_gru's max_len, which the
    JAX builders lack (they step through the LoDArray's capacity): with it
    the program is the JAX builder's but for the ops' max_len attr, and
    while every sequence fits, the output is the JAX builder's on the same
    weights, within 1e-5 of its scale, as the port's without it is."""
    rng = np.random.RandomState(3)
    seqs = [rng.randint(0, 20, (n, 1)).astype(np.int32) for n in (3, 1, 5)]
    build = lambda m, **kw: m.layers.sequence_pool(  # noqa: E731
        getattr(_nets(m), kind)(_ids(m), size=5, **kw), "max")
    jm, js = fresh(pt)
    with pt.program_guard(jm, js):
        jout = build(pt)
    w = weights(jm)
    jscope = pt.Scope()
    for n, a in w.items():
        jscope.set(n, jnp.asarray(a))
    want = pt.Executor().run(jm, feed={"ids": JLoD.from_sequences(seqs, capacity=32)},
                             fetch_list=[jout], scope=jscope)[0]
    for max_len in (None, 5):
        main, startup = fresh(ptt)
        with ptt.program_guard(main, startup):
            out = build(ptt, max_len=max_len)
        rnn = [op for op in main.global_block().ops if op.type in ("dynamic_lstm", "dynamic_gru")]
        assert {op.attrs.get("max_len") for op in rnn} == {max_len}
        for op in rnn:
            op.attrs["max_len"] = None
        assert main.to_dict() == jm.to_dict()
        for op in rnn:
            op.attrs["max_len"] = max_len
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, w, "cpu")
        got = ptt.Executor(device="cpu").run(
            main, {"ids": TLoD.from_sequences(seqs, capacity=32)}, [out], scope=scope)[0]
        assert_same(jnp.asarray(want), torch.as_tensor(got), 1e-5)
