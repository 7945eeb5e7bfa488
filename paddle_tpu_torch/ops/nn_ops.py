"""Convolution, pooling, normalisation, loss and metric op kernels:
`conv2d`, `conv2d_transpose`, `pool2d`, `batch_norm`, `layer_norm`,
`dropout`, `cross_entropy`, `softmax_with_cross_entropy`,
`square_error_cost`, `huber_loss`, `accuracy` and `lrn`
(paddle_tpu/ops/nn_ops.py:30, 74, 106, 146, 191-207, 210-226, 230, 247,
276, 285, 296, 310-324), on torch tensors.

The convolutions go to F.conv2d and F.conv_transpose2d (cuDNN on the
card), as the JAX package leaves them to XLA. An NHWC tensor reaches it as a channels-last NCHW view
(`permute(0, 3, 1, 2)`, no copy), so cuDNN runs its NHWC kernels and the
output comes back NHWC without a transpose; the filter stays OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..core.lod import LoDArray
from ..core.registry import register_op
from ..flags import FLAGS
from .fused_conv_kernels import sum_sq


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _nchw(x, fmt):
    """x as an NCHW tensor (a view of an NHWC one) and the inverse view."""
    if fmt == "NCHW":
        return x, lambda t: t
    if fmt != "NHWC":
        raise ValueError(f"unsupported data_format {fmt!r}")
    return x.permute(0, 3, 1, 2), lambda t: t.permute(0, 2, 3, 1)


@register_op("conv2d")
def conv2d_kernel(ctx):
    """Strides, symmetric paddings, dilations and groups as the JAX op
    takes them. Under amp the inputs drop to bf16 and the output stays
    bf16 (f32 accumulation inside cuDNN). In f32 the JAX op multiplies in
    full f32 (preferred_element_type=f32), and cuDNN would by default round
    each operand to TF32 (10 mantissa bits): on the card the Executor turns
    `torch.backends.cudnn.allow_tf32` off when it is made (core/executor.py)
    rather than this op scoping it, because autograd runs the convolution's
    backward later, outside the op."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    xc, wc = amp.cast_inputs(ctx, x, w)
    x4, back = _nchw(xc, ctx.attr("data_format", "NCHW"))
    out = F.conv2d(x4, wc.to(xc.dtype), stride=_pair(ctx.attr("strides", (1, 1))),
                   padding=_pair(ctx.attr("paddings", (0, 0))),
                   dilation=_pair(ctx.attr("dilations", (1, 1))), groups=ctx.attr("groups", 1))
    out = back(out)
    if ctx.has_input("Bias"):
        shape = (1, -1, 1, 1) if ctx.attr("data_format", "NCHW") == "NCHW" else (1, 1, 1, -1)
        out = out + ctx.input("Bias").reshape(shape).to(out.dtype)
    ctx.set_output("Output", out)


@register_op("conv2d_transpose")
def conv2d_transpose_kernel(ctx):
    """The fractionally strided convolution of the JAX op (NCHW, strides
    and symmetric paddings): its Filter is [in_c, out_c, kh, kw], the
    layout F.conv_transpose2d takes. Under amp bf16 operands and a bf16
    output, f32 accumulation inside cuDNN; in f32 no TF32, as conv2d."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    xc, wc = amp.cast_inputs(ctx, x, w)
    out = F.conv_transpose2d(xc, wc.to(xc.dtype), stride=_pair(ctx.attr("strides", (1, 1))),
                             padding=_pair(ctx.attr("paddings", (0, 0))))
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias").reshape(1, -1, 1, 1).to(out.dtype)
    ctx.set_output("Output", out)


@register_op("pool2d")
def pool2d_kernel(ctx):
    """Max pooling pads with -inf; average pooling sums the window and
    divides in x's dtype, by the window's size or, `exclusive` with
    padding, by the count of its unpadded elements, as the JAX op does.
    `global_pooling` takes the whole plane. One difference in bf16: the
    port sums a window in f32 and rounds the sum once (F.avg_pool2d), where
    the JAX op's reduce_window on the CPU sums in bf16, rounding after each
    add; at the tests' shapes the two lie up to 86 bf16 ulps apart."""
    fmt = ctx.attr("data_format", "NCHW")
    x4, back = _nchw(ctx.input("X"), fmt)
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", (2, 2)))
    stride = _pair(ctx.attr("strides", (2, 2)))
    pad = _pair(ctx.attr("paddings", (0, 0)))
    if ctx.attr("global_pooling", False):
        ksize = stride = tuple(x4.shape[2:])
        pad = (0, 0)
    if ptype == "max":
        if any(2 * p > k for p, k in zip(pad, ksize)):  # F.max_pool2d's limit
            x4 = F.pad(x4, (pad[1], pad[1], pad[0], pad[0]), value=float("-inf"))
            pad = (0, 0)
        out = F.max_pool2d(x4, ksize, stride, pad)
    elif ptype == "avg":
        summed = F.avg_pool2d(x4, ksize, stride, pad, divisor_override=1)
        if ctx.attr("exclusive", True) and pad != (0, 0):
            ones = torch.ones((1, 1) + tuple(x4.shape[2:]), dtype=x4.dtype, device=x4.device)
            out = summed / F.avg_pool2d(ones, ksize, stride, pad, divisor_override=1)
        else:
            out = summed / float(ksize[0] * ksize[1])
    else:
        raise NotImplementedError(f"pool2d: pooling_type {ptype!r} is not ported yet")
    ctx.set_output("Out", back(out))


def update_running(ctx, bmean, bvar):
    """momentum·running + (1 − momentum)·batch into the Mean and Variance
    persistables, which the executor writes back to the scope. Made from
    the detached batch statistics, so they hold no autograd graph."""
    m = ctx.attr("momentum", 0.9)
    for slot, batch in (("Mean", bmean), ("Variance", bvar)):
        ctx.env[ctx.op.inputs[slot][0]] = m * ctx.input(slot) + (1 - m) * batch.detach()


@register_op("batch_norm")
def batch_norm_kernel(ctx):
    """Train mode: the batch's mean and biased variance over every axis but
    the channel's, in f32 even under amp, and the running statistics
    updated; `is_test` normalises with the running statistics. Under
    FLAGS.bn_bf16_stats (the default, as in the JAX package) the variance
    is max(E[x²] − E[x]², 0) with x squared in its own dtype; off, the mean
    of (x − mean)² in f32. The output is ((x − mean)·inv)·scale + bias in
    f32, cast to x's dtype."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    ch = x.dim() - 1 if ctx.attr("data_format", "NCHW") == "NHWC" else 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = tuple(-1 if i == ch else 1 for i in range(x.dim()))
    x32 = x.float()
    if ctx.attr("is_test", False):
        mean, var = ctx.input("Mean"), ctx.input("Variance")
    elif FLAGS.bn_bf16_stats:
        n = x.numel() // x.shape[ch]
        s, sq = sum_sq(x, axes, f32_squares=False)
        mean = s / n
        var = torch.clamp_min(sq / n - mean * mean, 0.0)
        update_running(ctx, mean, var)
    else:
        mean = x32.mean(axes)
        var = (x32 - mean.reshape(shape)).square().mean(axes)
        update_running(ctx, mean, var)
    inv = torch.rsqrt(var + eps)
    out = ((x32 - mean.reshape(shape)) * inv.reshape(shape) * scale.reshape(shape)
           + bias.reshape(shape))
    ctx.set_output("Y", out.to(x.dtype))


@register_op("cross_entropy")
def cross_entropy_kernel(ctx):
    """-log(X[label] + 1e-8) of a probability distribution X [N, D], an int
    Label [N, 1]; with `soft_label` a distribution Label [N, D] and
    -Σ label·log(X + 1e-8) (cross_entropy_op.cc). In X's dtype."""
    x, label = ctx.input("X"), ctx.input("Label")
    eps = 1e-8
    if ctx.attr("soft_label", False):
        out = -(label * torch.log(x + eps)).sum(-1, keepdim=True)
    else:
        lbl = label[..., 0] if label.dim() == x.dim() else label
        out = -torch.log(torch.gather(x, -1, lbl[..., None].long()) + eps)
    ctx.set_output("Y", out)


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy_kernel(ctx):
    """Log-softmax in f32 even under amp (loss numerics); an int Label picks
    each row's term, a `soft_label` distribution weighs them all. Ragged
    (LoDArray) logits give a per-token LoD loss [capacity, 1] with the
    padding slots zeroed. Softmax is set only where the run reads it: the
    training program does not, and at [B·T, V] it is the step's largest
    tensor."""
    logits_in = ctx.input("Logits")
    label_in = ctx.input("Label")
    ragged = isinstance(logits_in, LoDArray)
    logits = logits_in.data if ragged else logits_in
    label = label_in.data if isinstance(label_in, LoDArray) else label_in
    logp = torch.log_softmax(logits.float(), dim=-1)
    if ctx.attr("soft_label", False):
        loss = -(label * logp).sum(-1, keepdim=True)
    else:
        lbl = label[..., 0] if label.dim() == logits.dim() else label
        lbl = lbl.long().clamp(0, logits.shape[-1] - 1)
        loss = -torch.gather(logp, -1, lbl[..., None])
    wrap = logits_in.with_data if ragged else (lambda t: t)
    if ragged:
        loss = torch.where(logits_in.token_mask[:, None], loss, torch.zeros((), device=loss.device))
    if ctx.output_read("Softmax"):
        ctx.set_output("Softmax", wrap(logp.exp()))
    ctx.set_output("Loss", wrap(loss))


@register_op("square_error_cost")
def square_error_cost_kernel(ctx):
    """(X - Y)², elementwise (squared_l2_distance_op.cc)."""
    x, y = ctx.input("X"), ctx.input("Y")
    ctx.set_output("Out", torch.square(x - y))


@register_op("huber_loss")
def huber_loss_kernel(ctx):
    """r = Y - X; ½r² where |r| <= delta, else delta·(|r| - ½delta)."""
    x, y = ctx.input("X"), ctx.input("Y")
    d = ctx.attr("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    ctx.set_output("Out", torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d)))


@register_op("accuracy")
def accuracy_kernel(ctx):
    """The share of rows whose label is among their top-k indices
    (accuracy_op.cc), as an f32 scalar; `Correct` and `Total` as int32
    counts where the op names them."""
    indices, label = ctx.input("Indices"), ctx.input("Label")
    correct = (indices == label.to(indices.dtype)).any(dim=-1)
    ctx.set_output("Accuracy", correct.to(torch.float32).mean())
    if ctx.has_output("Correct"):
        ctx.set_output("Correct", correct.sum(dtype=torch.int32))
    if ctx.has_output("Total"):
        ctx.set_output("Total", torch.full((), indices.shape[0], dtype=torch.int32,
                                           device=indices.device))


@register_op("layer_norm")
def layer_norm_kernel(ctx):
    """Normalises over the axes from begin_norm_axis on: statistics in f32
    (the biased variance) even under amp, the f32 Scale and Bias applied in
    f32, the output in x's dtype."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(ctx.attr("begin_norm_axis", 1), x.dim()))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    if ctx.has_input("Scale"):
        out = out * ctx.input("Scale")
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias")
    ctx.set_output("Y", out.to(x.dtype))


def dropout_apply(x, mask):
    """Train-mode dropout with a given 0/1 `mask` of x's shape: x · mask in
    x's dtype, no rescale. Its gradient is the mask."""
    return x * mask.to(x.dtype)


@register_op("dropout", runs_once=lambda op, env: not op.attrs.get("is_test", False))
def dropout_kernel(ctx):
    """v0.11's dropout (dropout_op.cc), not torch's: in train mode
    x · mask with mask ~ Bernoulli(1 − p) and no 1/(1 − p) rescale; in test
    mode x · (1 − p), the factor rounded to x's dtype first as the JAX op's
    weakly typed scalar is. The mask is drawn from the run's generator (a
    window's is registered with its graph, core/graph.py), over every slot
    of a LoD input's data, padding included; the LoD is kept."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    data = x.data if isinstance(x, LoDArray) else x
    if ctx.attr("is_test", False):
        out = data * torch.tensor(1.0 - p, dtype=data.dtype, device=data.device)
    else:
        gen = ctx.generator()
        mask = torch.rand(data.shape, generator=gen, device=gen.device) < 1.0 - p
        out = dropout_apply(data, mask)
    ctx.set_output("Out", x.with_data(out) if isinstance(x, LoDArray) else out)


@register_op("lrn")
def lrn_kernel(ctx):
    """Local response normalisation across the channels of NCHW x:
    x / (k + alpha · Σ_window x²)^beta over a window of n channels centred
    on each (zero past the edges). As the JAX op: no alpha/n scaling, the
    window's squares summed in channel order, in x's dtype."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    half = n // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, half))
    windows = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    k, alpha, beta = ctx.attr("k", 2.0), ctx.attr("alpha", 1e-4), ctx.attr("beta", 0.75)
    ctx.set_output("Out", x / torch.pow(k + alpha * windows, beta))
