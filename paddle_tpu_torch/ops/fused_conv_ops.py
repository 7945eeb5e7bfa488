"""The fused 1x1 conv + BatchNorm protocol's ops (paddle_tpu/ops/
fused_conv_ops.py): `fused_conv_bn` (:336), `bn_stats` (:395) and
`bn_apply` (:410), on NHWC torch tensors.

A bottleneck's 1x1 convs emit their raw output with its batch statistics,
and the previous BN's normalise (+ReLU) runs inside the next conv's operand
read (the prologue), so a normalised activation need not be written at
all. `fused_conv_bn` routes its product three ways, as the JAX op does
(:376-387), by the flags:

- N ≤ fused_conv_dot_max_n with fused_conv_pallas on and the kernel's
  eligibility holding (ops/fused_conv_kernels.py): the hand-written
  kernel, under the autograd Function whose backward transcribes the
  JAX package's;
- N ≤ fused_conv_dot_max_n otherwise: the 2-D plain formula when the
  kernel is off (its statistics by FLAGS.bn_bf16_stats, where the kernel
  and its plain version square in f32, as the TPU kernel does), the 4-D
  route when the kernel is on but refuses the shape (never the plain
  version in the kernel's place);
- N > fused_conv_dot_max_n: the 4-D route, a 1x1 F.conv2d (cuDNN) on the
  prologued activation, and the same statistics; autograd differentiates
  it.

At ResNet-50's shapes the kernel takes all 36 calls (Cin and Cout
multiples of 64), where the TPU rule takes 29: its Cin % 128 and
Cout % 128 refuse stage 1's seven 64-channel calls. The JAX op's mesh
branch has no counterpart: the port runs on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..core.registry import register_op
from ..flags import FLAGS
from . import fused_conv_kernels as fk
from .nn_ops import update_running


def stats_to_mean_inv(s, sq, n, eps):
    """Batch mean, biased variance max(sq/n − mean², 0) and 1/sqrt(var +
    eps), from the f32 sum and sum of squares of n rows."""
    mean = s / n
    var = torch.clamp_min(sq / n - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def _fused4(x4, w, vecs, relu):
    """The 4-D route: the prologue, then the product as a 1x1 conv on the
    NHWC activation seen as channels-last NCHW, the output rounded to the
    io dtype (f32 accumulation), and the per-channel statistics
    (FLAGS.bn_bf16_stats)."""
    xn = x4 if vecs is None else fk.prologue_plain(x4, *vecs, relu)
    y = F.conv2d(xn.permute(0, 3, 1, 2), w[:, :, None, None]).permute(0, 2, 3, 1)
    return (y, *fk.sum_sq(y, (0, 1, 2), not FLAGS.bn_bf16_stats))


@register_op("fused_conv_bn")
def fused_conv_bn_kernel(ctx):
    """1x1 conv (NHWC, an optional stride that subsamples first) with the
    previous BN's prologue and this BN's statistics; outputs the raw conv
    result and its batch mean and inv, and updates the running
    statistics."""
    x = ctx.input("X")          # [B, H, W, Cin]
    w = ctx.input("Filter")     # [Cout, Cin, 1, 1]
    stride = int(ctx.attr("stride", 1))
    if stride > 1:
        # a stride-s 1x1 conv reads every s-th pixel: a view, read in place
        x = x[:, ::stride, ::stride, :]
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    xc, wc = amp.cast_inputs(ctx, x, w.reshape(cout, cin))
    wc = wc.to(xc.dtype)
    n = b * h * wd
    relu = ctx.attr("prologue_act", None) == "relu"
    vecs = None
    if ctx.has_input("XMean"):
        vecs = tuple(ctx.input(s) for s in ("XMean", "XInv", "XScale", "XBias"))
    if n <= FLAGS.fused_conv_dot_max_n and not FLAGS.fused_conv_pallas:
        y2 = fk.conv1x1_plain(xc, wc, *(vecs or ()), relu=relu)
        s, sq = fk.sum_sq(y2, 0, not FLAGS.bn_bf16_stats)
        y = y2.reshape(b, h, wd, cout)
    elif n <= FLAGS.fused_conv_dot_max_n and fk.fused_conv_eligible(n, cin, cout, xc.dtype):
        y, s, sq = fk.fused_conv_bn_fused(xc, wc, *(vecs or (None,) * 4), relu=relu)
    else:
        y, s, sq = _fused4(xc, wc, vecs, relu)
    bmean, bvar, binv = stats_to_mean_inv(s, sq, float(n), ctx.attr("epsilon", 1e-5))
    update_running(ctx, bmean, bvar)
    ctx.set_output("Out", y)
    ctx.set_output("BatchMean", bmean)
    ctx.set_output("BatchInv", binv)


@register_op("bn_stats")
def bn_stats_kernel(ctx):
    """The statistics half of batch_norm over a raw NHWC activation: batch
    mean and inv, and the running-statistics update; the normalise runs in
    the consumer (bn_apply or a fused_conv_bn prologue)."""
    x = ctx.input("X")
    s, sq = fk.sum_sq(x, (0, 1, 2), not FLAGS.bn_bf16_stats)
    n = float(x.numel() // x.shape[-1])
    bmean, bvar, binv = stats_to_mean_inv(s, sq, n, ctx.attr("epsilon", 1e-5))
    update_running(ctx, bmean, bvar)
    ctx.set_output("BatchMean", bmean)
    ctx.set_output("BatchInv", binv)


@register_op("bn_apply")
def bn_apply_kernel(ctx):
    """(x − mean)·(inv·scale) + bias in f32, an optional ReLU, cast to x's
    dtype."""
    x = ctx.input("X")
    m, iv = ctx.input("Mean"), ctx.input("Inv")
    s, b = ctx.input("Scale"), ctx.input("Bias")
    y = (x.float() - m) * (iv * s) + b
    if ctx.attr("act", None) == "relu":
        y = torch.clamp_min(y, 0.0)
    ctx.set_output("Out", y.to(x.dtype))
