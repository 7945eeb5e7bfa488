"""The SSD detection ops against the JAX package
(paddle_tpu/ops/detection_ops.py).

Each op runs in both packages on the same numpy inputs, the JAX side
jitted: `prior_box` equal to the last bit (the same numpy table), the
helpers, `multibox_loss` and its gradient to Loc and Conf within 1e-5 of
each value's scale (its largest |value|, at least 1) in f32, on ground
truth with padding slots and equal IoUs (the first match wins, as in
`jnp.argmax`) and tied CE values among the negatives (ranked by a stable
sort). `detection_output`'s rows are equal in labels and within 1e-6 in
scores and boxes, with tied scores and with fewer survivors than
keep_top_k. SSD300's six maps give 8732 priors in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.ops import detection_ops as jdet
from paddle_tpu_torch.ops import detection_ops as tdet

# SSD300 (Liu et al. 2016) on VOC: the six maps and their prior settings
SSD300 = dict(maps=(38, 19, 10, 5, 3, 1), min_sizes=(30, 60, 111, 162, 213, 264),
              max_sizes=(60, 111, 162, 213, 264, 315),
              aspect_ratios=([2], [2, 3], [2, 3], [2, 3], [2], [2]))


def _jax_run(op, ins, outs, attrs, env):
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp

    def f(env):
        env = dict(env)
        jreg.get_kernel(op)(jreg.OpContext(JOp(op, ins, outs, attrs), env))
        return {n: env[n] for ns in outs.values() for n in ns}

    return jax.jit(f)(env)


def _torch_run(op, ins, outs, attrs, env):
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator as TOp

    env = dict(env)
    treg.get_kernel(op)(treg.OpContext(TOp(op, ins, outs, attrs), env))
    return env


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * scale)


def test_ssd300_priors_equal_jax():
    """prior_box on each of SSD300's maps in both packages (bit-equal), and
    num_priors: 4, 6, 6, 6, 4, 4 a location, 8732 in all."""
    img = np.zeros((1, 3, 300, 300), np.float32)
    total = 0
    for m, mn, mx, ar in zip(SSD300["maps"], SSD300["min_sizes"], SSD300["max_sizes"],
                             SSD300["aspect_ratios"]):
        attrs = {"min_sizes": [mn], "max_sizes": [mx], "aspect_ratios": ar,
                 "variances": [0.1, 0.1, 0.2, 0.2], "clip": True}
        feat = np.zeros((1, 2, m, m), np.float32)
        ins, outs = {"Input": ["f"], "Image": ["i"]}, {"Boxes": ["b"], "Variances": ["v"]}
        j = _jax_run("prior_box", ins, outs, attrs, {"f": jnp.asarray(feat),
                                                      "i": jnp.asarray(img)})
        t = _torch_run("prior_box", ins, outs, attrs, {"f": torch.as_tensor(feat),
                                                        "i": torch.as_tensor(img)})
        for k in ("b", "v"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        per = ptt.layers.num_priors([mn], [mx], ar)
        assert per == pt.layers.num_priors([mn], [mx], ar)
        assert t["b"].shape[0] == m * m * per
        total += t["b"].shape[0]
    assert total == 8732


def test_box_helpers_equal_jax():
    rng = np.random.RandomState(0)
    lo = rng.rand(2, 7, 2).astype(np.float32) * 0.6
    a = np.concatenate([lo, lo + rng.rand(2, 7, 2).astype(np.float32) * 0.4], -1)
    b = a[:, ::-1].copy()
    b[:, 0] = a[:, 0]  # an identical pair: IoU 1
    _close(tdet.iou_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
           jdet.iou_matrix(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (7, 1))
    enc = tdet.encode_boxes(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(var))
    _close(enc.numpy(), jdet.encode_boxes(jnp.asarray(a), jnp.asarray(b), jnp.asarray(var)),
           1e-6)
    _close(tdet.decode_boxes(enc, torch.as_tensor(b), torch.as_tensor(var)).numpy(), a, 1e-5)


def _mbox_inputs(n=3, k=24, g=4, c=5, seed=0):
    """Priors on a grid, ground truth with padding (label 0) and a box
    placed exactly on two priors' union (equal IoUs)."""
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(4)), -1).reshape(-1, 2) / 6.0
    priors = np.concatenate([grid, grid + 0.3], -1).astype(np.float32)[:k]
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (k, 1))
    gt = np.zeros((n, g, 4), np.float32)
    gtl = np.zeros((n, g), np.int32)
    for i in range(n):
        for s in range(g - i):  # image i has g - i boxes, the rest padding
            x0, y0 = rng.rand(2) * 0.6
            gt[i, s] = [x0, y0, x0 + 0.1 + 0.3 * rng.rand(), y0 + 0.1 + 0.3 * rng.rand()]
            gtl[i, s] = rng.randint(1, c)
    gt[0, 1] = [priors[0, 0], priors[0, 1], priors[1, 2], priors[0, 3]]  # ties
    loc = (0.5 * rng.randn(n, k, 4)).astype(np.float32)
    conf = np.round(rng.randn(n, k, c), 1).astype(np.float32)  # repeated CE values
    return dict(Loc=loc, Conf=conf, Priors=priors, PriorVar=pvar, GtBox=gt, GtLabel=gtl)


@pytest.mark.parametrize("thresh,ratio", [(0.5, 3.0), (0.2, 1.0)])
def test_multibox_loss_and_gradient_equal_jax(thresh, ratio):
    inp = _mbox_inputs()
    attrs = {"overlap_threshold": thresh, "neg_pos_ratio": ratio}
    ins = {k: [k] for k in inp}
    cot = np.random.RandomState(5).rand(3, 1).astype(np.float32)
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp

    def jf(loc, conf):
        env = {k: jnp.asarray(v) for k, v in inp.items()}
        env.update(Loc=loc, Conf=conf)
        jreg.get_kernel("multibox_loss")(jreg.OpContext(
            JOp("multibox_loss", ins, {"Out": ["o"]}, attrs), env))
        return env["o"]

    jo, (jgl, jgc) = jax.jit(lambda a, b: (lambda o, vjp: (o, vjp(jnp.asarray(cot))))(
        *jax.vjp(jf, a, b)))(jnp.asarray(inp["Loc"]), jnp.asarray(inp["Conf"]))
    env = {k: torch.as_tensor(v) for k, v in inp.items()}
    env["Loc"].requires_grad_(True)
    env["Conf"].requires_grad_(True)
    t = _torch_run("multibox_loss", ins, {"Out": ["o"]}, attrs, env)
    (t["o"] * torch.as_tensor(cot)).sum().backward()
    _close(t["o"].detach().numpy(), jo, 1e-5)
    _close(env["Loc"].grad.numpy(), jgl, 1e-5)
    _close(env["Conf"].grad.numpy(), jgc, 1e-5)


@pytest.mark.parametrize("keep_top_k", [6, 40])
def test_detection_output_equals_jax(keep_top_k):
    """Tied scores (conf rounded to 0.5) across classes and priors; with
    keep_top_k 40 fewer boxes survive than the rows, which pad with -1."""
    inp = _mbox_inputs(seed=1)
    conf = (np.round(np.random.RandomState(2).randn(3, 24, 5) * 2) / 2).astype(np.float32)
    env = dict(Loc=inp["Loc"] * 0.3, Conf=conf, Priors=inp["Priors"],
               PriorVar=inp["PriorVar"])
    ins, outs = {k: [k] for k in env}, {"Out": ["o"]}
    attrs = {"confidence_threshold": 0.15, "nms_threshold": 0.3, "nms_top_k": 10,
             "keep_top_k": keep_top_k, "background_id": 0}
    j = np.asarray(_jax_run("detection_output", ins, outs, attrs,
                            {k: jnp.asarray(v) for k, v in env.items()})["o"])
    t = _torch_run("detection_output", ins, outs, attrs,
                   {k: torch.as_tensor(v) for k, v in env.items()})["o"].numpy()
    assert t.shape == j.shape == (3, keep_top_k, 6)
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    _close(t[..., 1:], j[..., 1:], 1e-6)
    if keep_top_k == 40:
        assert (t[..., 0] == -1).any() and (t[..., 0] != -1).any()
