"""bench.py's ResNet-50 training program (`_build_resnet_train`,
bench.py:158-192) in the port against the JAX package, on the CPU: the
fused 1x1 conv + BN unit (B11) and its VJP, each new op, the program at
full width, and two Momentum steps of full-depth `resnet_imagenet` at
64x64, B=4, 10 classes.

The JAX side runs its Pallas kernel (`_fused_fn`) in interpret mode; the
port's unit on CPU tensors runs the kernel's plain version forward and
the transcribed backward, the backward the card runs.

Tolerances, each with its reading:

- The unit against `_fused_fn` and its VJP: f32 within 2e-6 of each
  output's largest element (measured at most 3.2e-7). bf16: y, dx and dW
  are products rounded once from f32 sums taken in another order, and
  dy_c's bf16 operations may round one ulp apart, so at most 2% of their
  elements differ (measured 0.012%), within 1e-2 of the largest element
  (2.5e-3); s, sq and the prologue vectors' gradients are f32 sums of
  those values, within 2e-4 (5.4e-5, dps, where r1 − pm·r0 cancels).
- The ops, f32: within 1e-5 of each output's largest element (XLA and
  torch sum in other orders, and the batch variance max(sq/n − mean², 0)
  cancels: measured at most 8.5e-7, a BatchInv). bf16: at most 2% of the
  elements differ (0.011%), by at most one ulp; their f32 statistics
  within 2e-5 (6.6e-7). Each op with batch statistics runs with
  `bn_bf16_stats` on (both packages' default: the activation squared in
  bf16 before the f32 sum) and off (squared in f32), the same on both
  sides; a port that ignored the flag fails eight of the bf16 cases (its
  statistics past 2e-5). Average pooling in bf16 is held to the JAX op in
  f32 on the same values, within 2^-7 of the largest element (3.0e-3):
  the JAX op sums a bf16 window in bf16 on the CPU (up to 86 ulps from
  the port here), where the port sums in f32.
- The model. Its gradient is ill-conditioned at the JAX package's own
  initial state: the gradient of the scale of every branch2a and branch2b
  BatchNorm is 0 in exact arithmetic (a BN output that feeds ReLU, a conv
  and another BN is scale-invariant while its bias is 0), so what both
  packages compute there is rounding noise; and the other gradients move
  by up to 3.7% (relative L2, 2.6% median) when the JAX package's own
  input images move by one part in 1e7 (the raw-statistics BN backward
  cancels; test_reference_gradient_is_ill_conditioned). A first step
  moves the parameters by lr times that noise, which the second step's
  gradients amplify in turn; so the steps run at lr 1e-5, and each
  quantity is held to a bound over its reading:

  f32 (the JAX side on its B11 route, Pallas in interpret mode): the
  first loss within 1e-3 relative (measured 1.3e-4), the second within
  1e-2 (3.8e-4); the first step's gradients within 0.1 relative L2
  (4.5e-2); after two steps the velocities and the parameters' updates
  within 0.3 (1.4e-1 and 1.3e-1); the BN running statistics within 1e-2
  (1.3e-3). The null gradients (the scales above) are held as bf16's
  gradients are (measured 0.986-1.048). The bounds catch a fault in the unit's backward, in a
  copy of the port: with the sum-of-squares cotangent dropped from dy_c
  the first step's gradients read up to 39 relative L2 (median 0.92);
  with the prologue's ReLU mask dropped up to 76 (median 7.0).

  bf16 (the JAX side on its default route, the 4-D conv, compiled with
  XLA's excess precision off): the raw-statistics backward cancels in
  bf16, and the JAX package's own bf16 gradients lie 1.31 (median
  relative L2, the same test) from its f32 ones: the gradients of both packages are
  noise of one size. So the losses within 5e-2 and 1e-1 relative
  (measured 1.9e-2 and 5.5e-2), the running statistics within 0.5
  relative L2 (0.14), and each gradient, velocity and update's norm
  within a factor 2 of the JAX package's (measured 0.82-1.35); the
  unit's bf16 backward is held element by element above.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import models
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.ops.fused_conv_ops import _fused_fn
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.ops import fused_conv_kernels as fk

F32, BF16 = torch.float32, torch.bfloat16
_JDT = {F32: jnp.float32, BF16: jnp.bfloat16}


def _set_stats(mp, bf16_stats):
    """`bn_bf16_stats` on both sides (both default to True: the statistics
    square the activation in its io dtype before their f32 sums)."""
    mp.setattr(JFLAGS, "bn_bf16_stats", bf16_stats)
    mp.setattr(ptt.FLAGS, "bn_bf16_stats", bf16_stats)


# the ops whose statistics follow bn_bf16_stats: their cases run with it on
# (the default, no suffix) and off ("-f32-stats")
_STATS_OPS = ("batch_norm", "fused_conv_bn", "bn_stats")


def build(pkg, hw=224, class_dim=1000, lr=0.1):
    """bench.py's _build_resnet_train through `pkg`'s front end (NHWC,
    Momentum(lr, 0.9), bf16 amp), names counted from 0. Returns (main,
    startup, loss)."""
    if pkg is pt:
        pt.reset()
        zoo = models
    else:
        ptt.reset_default_programs()
        zoo = ptt.models
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        img = pkg.layers.data("img", shape=[hw, hw, 3])
        label = pkg.layers.data("label", shape=[1], dtype=np.int32)
        logits = zoo.resnet_imagenet(img, class_dim=class_dim, data_format="NHWC")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    prog.set_amp("bfloat16")
    return prog, startup, loss


def _rounded(a, dtype):
    """numpy f32 values already rounded to dtype."""
    return torch.as_tensor(a).to(dtype).float().numpy()


def _rel(got, want):
    got = got.float().detach().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ulps(got, want):
    """(share of elements that differ, largest difference in bf16 ulps of
    the JAX value)."""
    got = got.float().detach().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return float(np.mean(got != want)), float((np.abs(got - want) / ulp).max())


# ------------------------------------------------------------------ unit --
def _unit_inputs(rng, n, cin, cout, dtype):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=_rounded(f(n, cin), dtype), w=_rounded(0.1 * f(cout, cin), dtype),
                pm=0.1 * f(cin), pi=1 + 0.1 * np.abs(f(cin)), ps=1 + 0.1 * f(cin),
                pb=0.1 * f(cin), dy=_rounded(f(n, cout), dtype), ds=f(cout), dsq=0.1 * f(cout))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "plain-input"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_unit_matches_pallas_kernel_and_vjp(dtype, prologue, relu):
    """fused_matmul_bn_plain, and _FusedConvBNFn on CPU tensors forward and
    backward, against `_fused_fn(prologue, relu, interpret=True)` and
    jax.vjp through its custom VJP, at a shape the TPU rule admits."""
    a = _unit_inputs(np.random.RandomState(1), 256, 128, 128, dtype)
    jdt = _JDT[dtype]
    vec_names = ("pm", "pi", "ps", "pb")
    jvecs = [jnp.asarray(a[k]) for k in vec_names]
    if not prologue:
        jvecs = [jnp.zeros(128), jnp.ones(128), jnp.ones(128), jnp.zeros(128)]
    jx, jw = jnp.asarray(a["x"]).astype(jdt), jnp.asarray(a["w"].T).astype(jdt)
    out, vjp = jax.vjp(_fused_fn(prologue, relu, True), jx, jw, *jvecs)
    jgrads = vjp((jnp.asarray(a["dy"]).astype(jdt), jnp.asarray(a["ds"]), jnp.asarray(a["dsq"])))

    tx = torch.as_tensor(a["x"]).to(dtype).requires_grad_(True)
    tw = torch.as_tensor(a["w"]).to(dtype).requires_grad_(True)
    tvecs = [torch.as_tensor(a[k]).requires_grad_(True) for k in vec_names] if prologue else []
    plain = fk.fused_matmul_bn_plain(tx.detach(), tw.detach(), *(v.detach() for v in tvecs),
                                     relu=relu)
    y, s, sq = fk.fused_conv_bn_fused(tx, tw, *(tvecs or [None] * 4), relu=relu)
    leaves = [tx, tw] + tvecs
    grads = torch.autograd.grad((y, s, sq), leaves, (torch.as_tensor(a["dy"]).to(dtype),
                                                     torch.as_tensor(a["ds"]),
                                                     torch.as_tensor(a["dsq"])))
    for got in (plain, (y, s, sq)):
        assert got[0].dtype == dtype and got[1].dtype == F32 and tuple(got[0].shape) == (256, 128)
        torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)
    want = list(jgrads[:2 + 4 * prologue])
    want[1] = want[1].T  # the port's filter is [Cout, Cin]
    named = [("y", y, out[0]), ("s", s, out[1]), ("sq", sq, out[2])] + list(
        zip(("dx", "dw", "dpm", "dpi", "dps", "dpb"), grads, want))
    for name, got, w in named:
        assert str(got.dtype)[6:] == jnp.dtype(w.dtype).name, name
        if dtype == F32 or got.dtype == F32:
            tol = 2e-6 if dtype == F32 else 2e-4
            assert _rel(got, w) <= tol, (name, _rel(got, w))
        else:
            share, ulps = _ulps(got, w)
            assert share <= 0.02 and _rel(got, w) <= 1e-2, (name, share, _rel(got, w))


def test_unit_checks_its_inputs():
    """Bad shapes, dtypes and prologue vectors raise on any device; the
    kernel's eligibility admits every fused_conv_bn of ResNet-50 at B=128."""
    x, w = torch.zeros(8, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="w must be"):
        fk.fused_matmul_bn(x, torch.zeros(64, 32))
    with pytest.raises(TypeError, match="io dtype"):
        fk.fused_matmul_bn(x.double(), w.double())
    with pytest.raises(ValueError, match="all four"):
        fk.fused_matmul_bn(x, w, torch.zeros(64))
    with pytest.raises(ValueError, match="prologue vectors"):
        fk.fused_matmul_bn(x, w, *[torch.zeros(32)] * 4)
    shapes = _resnet50_fused_shapes(128)
    assert len(shapes) == 36 and len(set(shapes)) == 15
    assert all(fk.fused_conv_eligible(n, ci, co, BF16) for n, ci, co in shapes)
    assert not fk.fused_conv_eligible(64, 48, 64, BF16)
    assert not fk.fused_conv_eligible(64, 64, 96, BF16)


# The bf16 kernel's planner (fused_conv_kernels.plan): a persistent grid of
# one CTA an SM on a 132-SM card, column tiles of up to 256 channels.
_SMS = 132


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_plan_deals_each_row_tile_to_one_cta(dtype):
    """Every ResNet-50 1x1 shape at B=128 (all 36 eligible): the column
    tile divides Cout (bf16: the widest of 256, 128, 64, so for Cout <= 256
    x is read once), the chunks cover the row tiles exactly once in
    ascending order with none empty, and the bf16 grid fits one wave."""
    shapes = _resnet50_fused_shapes(128)
    assert sum(fk.fused_conv_eligible(n, ci, co, dtype) for n, ci, co in shapes) == 36
    for n, _, cout in set(shapes):
        pl = fk.plan(n, cout, dtype, _SMS)
        assert cout % pl.col_tile == 0
        if dtype == BF16:
            assert pl.col_tile == min(cout, 256)
            assert (cout // pl.col_tile) * pl.chunks <= _SMS
        else:
            assert pl.col_tile == fk.COL_GRANULE
        n_tiles = math.ceil(n / fk.ROW_TILE)
        owners = [c for c in range(pl.chunks)
                  for _ in range(c * pl.tiles_per_chunk,
                                 min(n_tiles, (c + 1) * pl.tiles_per_chunk))]
        assert owners == sorted(owners) and len(owners) == n_tiles
        assert set(owners) == set(range(pl.chunks))


def test_plan_fixes_the_statistics_order():
    """The kernel sums each chunk's rows into one row of its workspace and
    then the rows in chunk order: an order set by the plan alone, which is a
    function of (N, Cout, dtype, SMs). The same sums taken that way in f32
    on the CPU are the same bits every time, and within f32 rounding of the
    plain version's statistics."""
    rng = np.random.RandomState(5)
    n, cout = 5000, 128
    y = torch.as_tensor(rng.standard_normal((n, cout)), dtype=BF16)
    pl = fk.plan(n, cout, BF16, 7)
    assert pl == fk.plan(n, cout, BF16, 7) and pl.chunks == 7

    def chunked(y):
        yf = y.float()
        rows = [yf[c * pl.tiles_per_chunk * fk.ROW_TILE:(c + 1) * pl.tiles_per_chunk * fk.ROW_TILE]
                for c in range(pl.chunks)]
        s = torch.zeros(cout)
        q = torch.zeros(cout)
        for r in rows:  # chunk order
            s = s + r.sum(0)
            q = q + (r * r).sum(0)
        return s, q

    a, b = chunked(y), chunked(y)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    want = fk.sum_sq(y, 0, f32_squares=True)
    for got, w in zip(a, want):
        assert float((got - w).abs().max()) <= 1e-5 * float(y.float().abs().sum(0).max())


def _resnet50_fused_shapes(batch):
    """(N, Cin, Cout) of each fused_conv_bn op of the 224x224 program."""
    prog, _, _ = build(ptt)
    shapes = {v.name: v.shape for v in prog.global_block().vars.values()}
    out = []
    for op in prog.global_block().ops:
        if op.type == "fused_conv_bn":
            x, w = shapes[op.inputs["X"][0]], shapes[op.inputs["Filter"][0]]
            s = op.attrs["stride"]
            out.append((batch * math.ceil(x[1] / s) * math.ceil(x[2] / s), x[3], w[0]))
    return out


# ------------------------------------------------------------------- ops --
def _run_op(op_type, inputs, attrs, amp=None, dtype=F32):
    """One op in both packages through each one's OpContext; `inputs` maps a
    slot to numpy arrays (float ones cast to `dtype` where they are
    activations: the X, Input slots). Returns (jax env, torch env) after
    the op, every value as f32 numpy."""
    slots = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in inputs.items()}
    jenv, tenv = {"@AMP@": amp}, {"@AMP@": amp}
    for k, vals in inputs.items():
        for name, v in zip(slots[k], vals):
            act = k in ("X", "Input") and v.dtype.kind == "f"
            jenv[name] = jnp.asarray(v).astype(_JDT[dtype]) if act else jnp.asarray(v)
            tenv[name] = torch.as_tensor(v).to(dtype) if act else torch.as_tensor(v)
    outs = {"conv2d": ("Output",), "pool2d": ("Out",), "batch_norm": ("Y",),
            "fused_conv_bn": ("Out", "BatchMean", "BatchInv"), "bn_stats": ("BatchMean", "BatchInv"),
            "bn_apply": ("Out",), "momentum": ("ParamOut", "VelocityOut")}[op_type]
    out_slots = {s: [f"out_{s}"] for s in outs}
    jreg.get_kernel(op_type)(jreg.OpContext(JOp(op_type, slots, out_slots, dict(attrs)), jenv))
    treg.get_kernel(op_type)(treg.OpContext(TOp(op_type, slots, out_slots, dict(attrs)), tenv))
    jn = {k: np.asarray(v, np.float32) for k, v in jenv.items() if k != "@AMP@"}
    tn = {k: v.detach().float().numpy() for k, v in tenv.items() if k != "@AMP@"}
    for k in tn:  # the same dtype on both sides
        assert str(tenv[k].dtype)[6:] == jnp.dtype(jenv[k].dtype).name, k
    return jn, tn


def _assert_op_close(jn, tn, dtype):
    assert set(jn) == set(tn)
    for k, j in jn.items():
        t = tn[k]
        assert t.shape == j.shape, k
        if dtype == F32 or k.startswith(("out_Batch", "Mean", "Variance")):
            tol = 1e-5 if dtype == F32 else 2e-5
            assert np.abs(t - j).max() <= tol * max(np.abs(j).max(), 1e-30), (k, _rel(t, j))
        else:
            share, ulps = _ulps(t, j)
            assert share <= 0.02 and ulps <= 1.0, (k, share, ulps)


def _op_cases():
    rng = np.random.RandomState(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: np.abs(f(*s)) + 0.1  # noqa: E731
    bn = lambda c: {"Scale": [1 + 0.1 * f(c)], "Bias": [0.1 * f(c)], "Mean": [0.1 * f(c)],  # noqa
                    "Variance": [pos(c)]}
    nhwc = {"data_format": "NHWC", "dilations": 1, "groups": 1}
    vec = lambda c: {"XMean": [0.5 * f(c)], "XInv": [pos(c)], "XScale": [1 + 0.1 * f(c)],  # noqa
                     "XBias": [0.1 * f(c)]}
    return [
        ("conv2d-7x7s2", "conv2d", {"Input": [f(2, 20, 20, 3)], "Filter": [0.2 * f(16, 3, 7, 7)]},
         dict(nhwc, strides=2, paddings=3)),
        ("conv2d-3x3", "conv2d", {"Input": [f(2, 9, 9, 16)], "Filter": [0.1 * f(16, 16, 3, 3)]},
         dict(nhwc, strides=1, paddings=1)),
        ("conv2d-3x3s2", "conv2d", {"Input": [f(2, 9, 9, 16)], "Filter": [0.1 * f(8, 16, 3, 3)]},
         dict(nhwc, strides=2, paddings=1)),
        ("conv2d-1x1", "conv2d", {"Input": [f(2, 6, 6, 32)], "Filter": [0.2 * f(16, 32, 1, 1)]},
         dict(nhwc, strides=1, paddings=0)),
        ("pool-max-pad", "pool2d", {"X": [f(2, 9, 9, 8)]},
         dict(pooling_type="max", ksize=3, strides=2, paddings=1, global_pooling=False,
              exclusive=True, data_format="NHWC")),
        ("pool-avg-global", "pool2d", {"X": [f(2, 7, 7, 8)]},
         dict(pooling_type="avg", ksize=2, strides=2, paddings=0, global_pooling=True,
              exclusive=True, data_format="NHWC")),
        ("pool-avg-exclusive", "pool2d", {"X": [f(2, 7, 7, 8)]},
         dict(pooling_type="avg", ksize=3, strides=2, paddings=1, global_pooling=False,
              exclusive=True, data_format="NHWC")),
        ("batch-norm-train", "batch_norm", dict(X=[1 + f(4, 5, 5, 16)], **bn(16)),
         dict(momentum=0.9, epsilon=1e-5, is_test=False, data_format="NHWC")),
        ("batch-norm-test", "batch_norm", dict(X=[f(4, 5, 5, 16)], **bn(16)),
         dict(momentum=0.9, epsilon=1e-5, is_test=True, data_format="NHWC")),
        ("fused-conv-bn", "fused_conv_bn",
         {"X": [f(4, 6, 6, 64)], "Filter": [0.1 * f(128, 64, 1, 1)], **{
             k: bn(128)[k] for k in ("Mean", "Variance")}},
         dict(stride=1, epsilon=1e-5, momentum=0.9, prologue_act="relu")),
        ("fused-conv-bn-prologue", "fused_conv_bn",
         {"X": [f(4, 6, 6, 64)], "Filter": [0.1 * f(128, 64, 1, 1)], **vec(64),
          **{k: bn(128)[k] for k in ("Mean", "Variance")}},
         dict(stride=1, epsilon=1e-5, momentum=0.9, prologue_act="relu")),
        ("fused-conv-bn-stride2", "fused_conv_bn",
         {"X": [f(4, 7, 7, 64)], "Filter": [0.1 * f(128, 64, 1, 1)],
          **{k: bn(128)[k] for k in ("Mean", "Variance")}},
         dict(stride=2, epsilon=1e-5, momentum=0.9, prologue_act="relu")),
        ("fused-conv-bn-prologue-linear-stride2", "fused_conv_bn",
         {"X": [f(4, 7, 7, 64)], "Filter": [0.1 * f(128, 64, 1, 1)], **vec(64),
          **{k: bn(128)[k] for k in ("Mean", "Variance")}},
         dict(stride=2, epsilon=1e-5, momentum=0.9, prologue_act=None)),
        ("bn-stats", "bn_stats", {"X": [1 + f(4, 5, 5, 32)], "Mean": [0.1 * f(32)],
                                  "Variance": [pos(32)]}, dict(epsilon=1e-5, momentum=0.9)),
        ("bn-apply-relu", "bn_apply", {"X": [f(4, 5, 5, 32)], "Mean": [0.1 * f(32)],
                                       "Inv": [pos(32)], "Scale": [1 + 0.1 * f(32)],
                                       "Bias": [0.1 * f(32)]}, dict(act="relu")),
        ("momentum", "momentum", {"Param": [f(6, 5)], "Grad": [f(6, 5)], "Velocity": [f(6, 5)],
                                  "LearningRate": [np.array(0.1, np.float32)]},
         dict(mu=0.9, use_nesterov=False)),
        ("momentum-nesterov", "momentum",
         {"Param": [f(6, 5)], "Grad": [f(6, 5)], "Velocity": [f(6, 5)],
          "LearningRate": [np.array(0.1, np.float32)]}, dict(mu=0.9, use_nesterov=True)),
    ]


@pytest.mark.parametrize("case,dtype,bf16_stats", [
    pytest.param(c, dt, stats, id=f"{c[0]}-{name}" + ("" if stats else "-f32-stats"))
    for c in _op_cases() for dt, name in ((F32, "f32"), (BF16, "bf16"))
    if not (dt == BF16 and c[1] == "momentum")  # the update of f32 master parameters
    for stats in ((True, False) if c[1] in _STATS_OPS and not c[3].get("is_test") else (True,))])
def test_op_matches_jax(case, dtype, bf16_stats, monkeypatch):
    """Every output and every value the op writes back (running
    statistics, parameter and velocity), the activations in `dtype` under
    bf16 amp, f32 parameters and statistics; an op with batch statistics
    with `bn_bf16_stats` on (both packages' default) and off."""
    _, op, inputs, attrs = case
    _set_stats(monkeypatch, bf16_stats)
    amp = "bfloat16" if dtype == BF16 else None
    jn, tn = _run_op(op, inputs, attrs, amp=amp, dtype=dtype)
    if dtype == BF16 and attrs.get("pooling_type") == "avg":
        # the JAX op sums a bf16 window in bf16 on the CPU; the port sums
        # in f32, rounds the sum and divides in bf16: held to the JAX op
        # in f32 on the same values (the module docstring)
        rounded = {k: [_rounded(v, BF16) for v in vals] for k, vals in inputs.items()}
        jn, _ = _run_op(op, rounded, attrs)
        assert _rel(tn["out_Out"], jn["out_Out"]) <= 2 ** -7, _rel(tn["out_Out"], jn["out_Out"])
        return
    _assert_op_close(jn, tn, dtype)


@pytest.mark.parametrize("route,dtype,bf16_stats", [
    pytest.param(r, dt, stats, id=r + ("" if dt == F32 else "-bf16")
                 + ("" if stats else "-f32-stats"))
    for r in ("4d", "2d", "kernel") for dt in (F32, BF16)
    for stats in ((True,) if dt == F32 else (True, False))])
def test_fused_conv_bn_routes_match_jax(route, dtype, bf16_stats):
    """The op's three routes, by the port's flags, against the JAX op on
    its 4-D route (the first two) or its Pallas kernel in interpret mode
    (the third): the output, the statistics and the running statistics,
    with the prologue, at a stride of 2; in f32, and in bf16 with
    `bn_bf16_stats` on and off, which the first two routes follow and the
    kernel, on both sides, does not (it squares its rounded y in f32)."""
    rng = np.random.RandomState(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inputs = {"X": [f(2, 16, 16, 128)], "Filter": [0.1 * f(128, 128, 1, 1)],
              "XMean": [0.5 * f(128)], "XInv": [np.abs(f(128)) + 0.1],
              "XScale": [1 + 0.1 * f(128)], "XBias": [0.1 * f(128)],
              "Mean": [0.1 * f(128)], "Variance": [np.abs(f(128)) + 0.1]}
    attrs = dict(stride=2, epsilon=1e-5, momentum=0.9, prologue_act="relu")
    with pytest.MonkeyPatch.context() as mp:
        for flags, name, value in ((JFLAGS, "fused_conv_interpret", route == "kernel"),
                                   (JFLAGS, "fused_conv_dot_max_n", 10 ** 6 * (route == "kernel")),
                                   (ptt.FLAGS, "fused_conv_pallas", route == "kernel"),
                                   (ptt.FLAGS, "fused_conv_dot_max_n", 10 ** 6 * (route != "4d"))):
            mp.setattr(flags, name, value)
        _set_stats(mp, bf16_stats)
        jn, tn = _run_op("fused_conv_bn", inputs, attrs, amp=None if dtype == F32 else "bfloat16",
                         dtype=dtype)
    _assert_op_close(jn, tn, dtype)


def test_flags():
    """fused_conv_dot_max_n keeps ints; bn_bf16_stats defaults to True, as
    the JAX package's does, and keeps a bool."""
    flags = ptt.FLAGS
    old = flags.fused_conv_dot_max_n
    try:
        flags.fused_conv_dot_max_n = 401408
        assert flags.fused_conv_dot_max_n == 401408
    finally:
        flags.fused_conv_dot_max_n = old
    assert flags.use_fused_conv is True and flags.fused_conv_pallas is False
    assert flags.bn_bf16_stats is True and JFLAGS.bn_bf16_stats is True
    try:
        flags.bn_bf16_stats = 0
        assert flags.bn_bf16_stats is False
    finally:
        flags.bn_bf16_stats = True


def test_executor_turns_cudnn_tf32_off_on_cuda(monkeypatch):
    """An Executor made for the card turns cuDNN's TF32 off (torch's default
    is on), so an f32 convolution, forward and backward, multiplies in f32
    as the JAX op does; the card is mocked here, and chip_smoke.py shows
    the effect on one. On the CPU it leaves the flags as they are."""
    from paddle_tpu_torch.core import executor

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    ptt.Executor(device="cpu")
    assert torch.backends.cudnn.allow_tf32 is True
    monkeypatch.setattr(executor, "resolve_device", lambda d: torch.device("cuda", 0))
    ptt.Executor()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


# --------------------------------------------------------------- program --
def test_program_matches_jax():
    """Main and startup at full width (224x224, 1000 classes, Momentum, bf16
    amp) serialize to the JAX package's dicts; 36 fused_conv_bn and 16
    bn_stats among the ops, 25,557,032 parameter values."""
    j_main, j_start, _ = build(pt)
    p_main, p_start, _ = build(ptt)
    for j, p in ((j_main, p_main), (j_start, p_start)):
        assert json.loads(json.dumps(p.to_dict())) == json.loads(json.dumps(j.to_dict()))
    ops = [o.type for o in p_main.global_block().ops]
    counts = {t: ops.count(t) for t in set(ops)}
    assert counts == {"fused_conv_bn": 36, "bn_apply": 36, "conv2d": 17, "relu": 17,
                      "elementwise_add": 17, "bn_stats": 16, "pool2d": 2, "batch_norm": 1,
                      "mul": 1, "softmax_with_cross_entropy": 1, "mean": 1, "autodiff": 1,
                      "momentum": 161}
    assert sum(math.prod(p.shape) for p in p_main.parameters()) == 25_557_032
    start_ops = [o.type for o in p_start.global_block().ops]
    assert {t: start_ops.count(t) for t in set(start_ops)} == {
        "fill_constant": 375, "gaussian_random": 53, "uniform_random": 1}


# -------------------------------------------------------------- training --
TRAIN = dict(hw=64, batch=4, class_dim=10, lr=1e-5)
# branch2a and branch2b BN scales: gradients 0 in exact arithmetic at the
# initial state (see the module docstring)
_NULL = ("branch2a_bn.w_0", "branch2b_bn.w_0")


def _feeds():
    rng = np.random.RandomState(0)
    hw, b, c = TRAIN["hw"], TRAIN["batch"], TRAIN["class_dim"]
    return [{"img": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
             "label": rng.randint(0, c, (b, 1)).astype(np.int32)} for _ in range(2)]


def _train_jax(state, feeds, amp, nudged=None):
    """Two steps on `feeds`; with `nudged` (a feed), also the first-step
    gradients on it from `state` again, through the same compiled step."""
    prog, _, loss = build(pt, TRAIN["hw"], TRAIN["class_dim"], TRAIN["lr"])
    prog.set_amp(amp)
    scope = pt.global_scope()
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    grads = [p.name + "@GRAD" for p in prog.parameters()]
    exe = pt.Executor()
    jit = jax.jit
    try:
        if amp:
            jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        # one fetch list for both steps: one compiled step
        first = exe.run(prog, feed=feeds[0], fetch_list=[loss.name] + grads)
        second = exe.run(prog, feed=feeds[1], fetch_list=[loss.name] + grads)
        after = {n: np.array(scope.get(n), np.float32) for n in state}
        if nudged is not None:
            for n, v in state.items():
                scope.set(n, jnp.asarray(v))
            moved = exe.run(prog, feed=nudged, fetch_list=[loss.name] + grads)
    finally:
        jax.jit = jit
    out = ([float(first[0]), float(second[0])],
           {g: np.asarray(a, np.float32) for g, a in zip(grads, first[1:])}, after)
    if nudged is not None:
        out += ({g: np.asarray(a, np.float32) for g, a in zip(grads, moved[1:])},)
    return out


def _train_port(state, feeds, amp):
    prog, _, loss = build(ptt, TRAIN["hw"], TRAIN["class_dim"], TRAIN["lr"])
    prog.set_amp(amp)
    scope = ptt.Scope()
    ptt.io.params_from_numpy(scope, state, "cpu")
    grads = [p.name + "@GRAD" for p in prog.parameters()]
    exe = ptt.Executor(device="cpu")
    first = exe.run(prog, feeds[0], [loss.name] + grads, scope=scope)
    second = exe.run(prog, feeds[1], [loss.name], scope=scope)
    return ([float(first[0]), float(second[0])], dict(zip(grads, first[1:])),
            ptt.io.state_to_numpy(scope, list(state)))


@pytest.fixture(scope="module")
def runs():
    """Two steps in each package from the JAX startup's state, f32 on the
    B11 routes (the JAX side's Pallas kernel in interpret mode, the port's
    kernel Function), bf16 on the JAX side's default 4-D route and the
    port's B11 route."""
    prog, startup, _ = build(pt, TRAIN["hw"], TRAIN["class_dim"], TRAIN["lr"])
    startup.random_seed = 3
    pt.Executor().run(startup)
    scope = pt.global_scope()
    state = {v.name: np.array(scope.get(v.name)) for v in prog.persistables()}
    feeds = _feeds()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptt.FLAGS, "fused_conv_pallas", True)
        mp.setattr(ptt.FLAGS, "fused_conv_dot_max_n", 10 ** 9)
        for amp in (None, "bfloat16"):
            mp.setattr(JFLAGS, "fused_conv_interpret", amp is None)
            mp.setattr(JFLAGS, "fused_conv_dot_max_n", 10 ** 9 if amp is None else 0)
            nudged = None
            if amp is None:  # the first feed's images moved by one part in 1e7
                noise = np.random.RandomState(9).standard_normal(feeds[0]["img"].shape)
                nudged = dict(feeds[0], img=(feeds[0]["img"] * (1 + 1e-7 * noise)).astype(
                    np.float32))
            jax_run = _train_jax(state, feeds, amp, nudged)
            if nudged is not None:
                out["nudged"] = jax_run[3]
            out[amp] = (jax_run[:3], _train_port(state, feeds, amp))
    return state, out


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _norm_ratio(got, want):
    return float(np.linalg.norm(got) / max(np.linalg.norm(want), 1e-30))


def test_reference_gradient_is_ill_conditioned(runs):
    """The readings behind the model's bounds, on the JAX package alone:
    its f32 first-step gradients move by more than 1% (relative L2, the
    median over the parameters with a gradient) when the images move by
    one part in 1e7, and its bf16 gradients lie further than 0.5 from its
    f32 ones."""
    _, out = runs
    jg, nudged, bf16 = out[None][0][1], out["nudged"], out["bfloat16"][0][1]
    null = lambda n: n.endswith(tuple(s + "@GRAD" for s in _NULL))  # noqa: E731
    moved = [_rel_l2(nudged[n], a) for n, a in jg.items() if not null(n)]
    apart = [_rel_l2(bf16[n], a) for n, a in jg.items() if not null(n)]
    print(f"nudged: median {np.median(moved):.3e}, max {max(moved):.3e}; bf16 from f32: "
          f"median {np.median(apart):.3f}")
    assert np.median(moved) > 1e-2 and np.median(apart) > 0.5


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
def test_two_momentum_steps_match_jax(runs, amp):
    """Both losses, every P@GRAD of the first step, and every parameter,
    velocity and BN running statistic after two steps, with the module
    docstring's bounds."""
    state, out = runs
    (jl, jg, js), (pl, pg, ps) = out[amp]
    f32 = amp is None
    for a, b, tol in zip(jl, pl, (1e-3, 1e-2) if f32 else (5e-2, 1e-1)):
        assert np.isfinite(b) and abs(a - b) <= tol * abs(a), (jl, pl)
    assert set(pg) == set(jg) and len(pg) == 161
    assert set(ps) == set(js) and len(js) == 161 * 2 + 106 + 1
    null = lambda n: n.endswith(_NULL) or n.endswith(tuple(s + "@GRAD" for s in _NULL))  # noqa
    for name, a in jg.items():
        b = pg[name]
        assert np.isfinite(b).all(), name
        if f32 and not null(name):
            assert _rel_l2(b, a) <= 0.1, (name, _rel_l2(b, a))
        else:
            assert 0.5 <= _norm_ratio(b, a) <= 2, (name, _norm_ratio(b, a))
    for name, a in js.items():
        b = ps[name]
        if name.endswith(".lr"):
            np.testing.assert_array_equal(b, a)
            continue
        running = name.endswith((".mean", ".variance"))
        if not running and ".velocity." not in name:  # a parameter: its update
            a, b = a - state[name], b - state[name]
        if running:
            assert _rel_l2(b, a) <= (1e-2 if f32 else 0.5), (name, _rel_l2(b, a))
        elif f32 and not null(name):
            assert _rel_l2(b, a) <= 0.3, (name, _rel_l2(b, a))
        else:
            assert 0.5 <= _norm_ratio(b, a) <= 2, (name, _norm_ratio(b, a))
