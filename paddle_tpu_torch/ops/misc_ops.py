"""Tensor-manipulation op kernels (paddle_tpu/ops/misc_ops.py), every op of
that module, on torch tensors; gradients by autograd.

Where the JAX op gathers rows, the port gathers with `F.embedding` (whose
backward sorts the ids and adds without atomics) or with a one-hot
product, so a step's bits do not change from run to run; `scatter` with
`overwrite=False` adds with `index_add`, which on the card adds duplicate
rows with atomics in no fixed order. Maxima reduce with `torch.amax`,
whose gradient splits evenly among tied maxima as JAX's max reduction
does (`maxout`, `spp`, `roi_pool`). `conv3d` and `pool3d` are cuDNN calls.
`sampling_id` draws from the run's generator (`runs_once`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..core.lod import LoDArray
from ..core.registry import register_op


def _data(x):
    return x.data if isinstance(x, LoDArray) else x


def _like(x, data):
    return x.with_data(data) if isinstance(x, LoDArray) else data


# ------------------------------------------------------- gather / scatter ---
@register_op("gather")
def gather_kernel(ctx):
    """X's rows at Index, by `F.embedding` over X's rows flattened."""
    x = _data(ctx.input("X"))
    idx = _data(ctx.input("Index")).reshape(-1).long()
    rows = F.embedding(idx, x.reshape(x.shape[0], -1))
    ctx.set_output("Out", rows.reshape((idx.shape[0],) + tuple(x.shape[1:])))


@register_op("scatter")
def scatter_kernel(ctx):
    """scatter_op.cc: Out = X with Out[Index] = Updates (overwrite) or
    += Updates."""
    x = _data(ctx.input("X"))
    idx = _data(ctx.input("Index")).reshape(-1).long()
    upd = _data(ctx.input("Updates")).to(x.dtype)
    out = x.index_copy(0, idx, upd) if ctx.attr("overwrite", True) else x.index_add(0, idx, upd)
    ctx.set_output("Out", out)


@register_op("one_hot")
def one_hot_kernel(ctx):
    """[N, depth] f32; an id outside [0, depth) gives a row of zeros."""
    x = _data(ctx.input("X")).reshape(-1).long()
    depth = ctx.attr("depth")
    cols = torch.arange(depth, device=x.device)
    ctx.set_output("Out", (x[:, None] == cols[None, :]).to(torch.float32))


# ------------------------------------------------------------------ pad -----
@register_op("pad")
def pad_kernel(ctx):
    """`paddings` flat [lo0, hi0, lo1, hi1, ...], filled with pad_value."""
    x = _data(ctx.input("X"))
    p = [int(v) for v in ctx.attr("paddings")]
    pads = [v for i in reversed(range(x.dim())) for v in (p[2 * i], p[2 * i + 1])]
    ctx.set_output("Out", F.pad(x, pads, value=ctx.attr("pad_value", 0.0)))


@register_op("crop")
def crop_kernel(ctx):
    """x[offsets : offsets + shape] along every axis, each offset clamped so
    the slice lies inside x, as lax.dynamic_slice clamps it."""
    x = _data(ctx.input("X"))
    index = []
    for dim, off, size in zip(x.shape, ctx.attr("offsets"), ctx.attr("shape")):
        start = min(max(int(off), 0), dim - int(size))
        index.append(slice(start, start + int(size)))
    ctx.set_output("Out", x[tuple(index)])


@register_op("multiplex")
def multiplex_kernel(ctx):
    """Row r of Out is row r of X[Ids[r]]."""
    ids = _data(ctx.input("Ids")).reshape(-1).long()
    xs = torch.stack([_data(x) for x in ctx.inputs("X")], 0)  # [n, rows, ...]
    idx = ids.reshape((1, -1) + (1,) * (xs.dim() - 2)).expand((1,) + tuple(xs.shape[1:]))
    ctx.set_output("Out", xs.gather(0, idx)[0])


# ------------------------------------------------------- simple transforms --
@register_op("maxout")
def maxout_kernel(ctx):
    """[N, C, H, W] -> [N, C/groups, H, W], the max of each channel group."""
    x = _data(ctx.input("X"))
    g = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", x.reshape(n, c // g, g, h, w).amax(2))


@register_op("prelu")
def prelu_kernel(ctx):
    x = _data(ctx.input("X"))
    alpha = _data(ctx.input("Alpha"))
    if ctx.attr("mode", "all") == "channel" and x.dim() == 4:
        alpha = alpha.reshape(1, -1, 1, 1)
    ctx.set_output("Out", torch.where(x > 0, x, alpha * x))


@register_op("cos_sim")
def cos_sim_kernel(ctx):
    """Row-wise cosine similarity over the last axis, times `scale`
    (CosSimLayer), its norms' product held at eps = 1e-8 or above."""
    x_in = ctx.input("X")
    x, y = _data(x_in), _data(ctx.input("Y"))
    num = (x * y).sum(-1, keepdim=True)
    den = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * \
        torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    ctx.set_output("Out", _like(x_in, ctx.attr("scale", 1.0) * num / den.clamp(min=1e-8)))


@register_op("dot_prod")
def dot_prod_kernel(ctx):
    x_in = ctx.input("X")
    ctx.set_output("Out", _like(x_in, (_data(x_in) * _data(ctx.input("Y"))).sum(
        -1, keepdim=True)))


@register_op("out_prod")
def out_prod_kernel(ctx):
    x, y = _data(ctx.input("X")), _data(ctx.input("Y"))
    ctx.set_output("Out", (x[:, :, None] * y[:, None, :]).reshape(x.shape[0], -1))


@register_op("l2_distance")
def l2_distance_kernel(ctx):
    x_in = ctx.input("X")
    d = _data(x_in) - _data(ctx.input("Y"))
    ctx.set_output("Out", _like(x_in, torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-12)))


@register_op("row_l2_norm")
def row_l2_norm_kernel(ctx):
    x_in = ctx.input("X")
    x = _data(x_in)
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    ctx.set_output("Out", _like(x_in, x / n.clamp(min=1e-12)))


@register_op("interpolation")
def interpolation_kernel(ctx):
    """w·x + (1 - w)·y, w a scalar a row (InterpolationLayer.cpp)."""
    x_in = ctx.input("X")
    w = _data(ctx.input("W")).reshape(-1, 1)
    ctx.set_output("Out", _like(x_in, w * _data(x_in) + (1.0 - w) * _data(ctx.input("Y"))))


@register_op("power")
def power_kernel(ctx):
    """x ** w, w a scalar a row (PowerLayer.cpp)."""
    x_in = ctx.input("X")
    ctx.set_output("Out", _like(x_in, torch.pow(_data(x_in),
                                                _data(ctx.input("W")).reshape(-1, 1))))


@register_op("scaling")
def scaling_kernel(ctx):
    """w·x, w a scalar a row (ScalingLayer.cpp)."""
    x_in = ctx.input("X")
    ctx.set_output("Out", _like(x_in, _data(ctx.input("W")).reshape(-1, 1) * _data(x_in)))


@register_op("slope_intercept")
def slope_intercept_kernel(ctx):
    x_in = ctx.input("X")
    ctx.set_output("Out", _like(x_in, ctx.attr("slope", 1.0) * _data(x_in)
                                + ctx.attr("intercept", 0.0)))


@register_op("sum_to_one_norm")
def sum_to_one_norm_kernel(ctx):
    x_in = ctx.input("X")
    x = _data(x_in)
    s = x.sum(-1, keepdim=True)
    ctx.set_output("Out", _like(x_in, x / torch.where(s.abs() < 1e-12, torch.ones_like(s), s)))


@register_op("convex_comb")
def convex_comb_kernel(ctx):
    """W [N, K], X [N, K·D] -> Σ_k w_k x_k [N, D] (ConvexCombinationLayer)."""
    w, x = _data(ctx.input("W")), _data(ctx.input("X"))
    n, k = w.shape
    ctx.set_output("Out", torch.einsum("nk,nkd->nd", w, x.reshape(n, k, -1)))


@register_op("scale_shift")
def scale_shift_kernel(ctx):
    out = _data(ctx.input("X")) * _data(ctx.input("Scale")).reshape(())
    if ctx.has_input("Bias"):
        out = out + _data(ctx.input("Bias")).reshape(())
    ctx.set_output("Out", out)


@register_op("scale_sub_region")
def scale_sub_region_kernel(ctx):
    """Scales the [c0:c1, h0:h1, w0:w1] box of an NCHW input (1-based,
    inclusive `indices`, ScaleSubRegionLayer)."""
    x = _data(ctx.input("X"))
    c0, c1, h0, h1, w0, w1 = [int(v) for v in ctx.attr("indices")]
    m = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    m[c0 - 1:c1, h0 - 1:h1, w0 - 1:w1] = 1.0
    m = m[None]
    ctx.set_output("Out", x * (1.0 - m) + x * m * ctx.attr("scale", 1.0))


@register_op("rotate")
def rotate_kernel(ctx):
    """The H x W planes turned 90 degrees counter-clockwise (RotateLayer)."""
    ctx.set_output("Out", torch.rot90(_data(ctx.input("X")), 1, dims=(-2, -1)))


@register_op("switch_order")
def switch_order_kernel(ctx):
    """NCHW -> NHWC (SwitchOrderLayer)."""
    ctx.set_output("Out", _data(ctx.input("X")).permute(0, 2, 3, 1).contiguous())


# ---------------------------------------------------------- interpolation ---
def _interp_matrix(n_out: int, n_in: int, dtype, device):
    """[n_out, n_in]: row o weighs in-pixels floor(o·r) and the next by
    1 - frac and frac, r = (n_in - 1)/(n_out - 1) (align_corners)."""
    r = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    pos = torch.arange(n_out, device=device) * r
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = (pos - lo).to(dtype)
    cols = torch.arange(n_in, device=device)
    return ((1 - frac)[:, None] * (cols[None, :] == lo[:, None]).to(dtype)
            + frac[:, None] * (cols[None, :] == hi[:, None]).to(dtype))


@register_op("bilinear_interp")
def bilinear_interp_kernel(ctx):
    """NCHW bilinear resize with align_corners (BilinearInterpLayer's ratio
    (in - 1)/(out - 1)), as two products with the 2-tap interpolation
    matrices, whose backward needs no atomics."""
    x = _data(ctx.input("X"))
    x = x.to(torch.promote_types(x.dtype, torch.float32))  # f32 weights, as in JAX
    oh, ow = ctx.attr("out_h"), ctx.attr("out_w")
    ay = _interp_matrix(oh, x.shape[2], x.dtype, x.device)
    ax = _interp_matrix(ow, x.shape[3], x.dtype, x.device)
    ctx.set_output("Out", torch.matmul(torch.matmul(ay, x), ax.T))


# ------------------------------------------------------------ conv family ---
@register_op("im2sequence")
def im2sequence_kernel(ctx):
    """BlockExpandLayer: conv-style patches, one step a patch position:
    [N, outH·outW, C·kh·kw] (channel, then kernel row and column)."""
    x = _data(ctx.input("X"))
    patches = F.unfold(x, (ctx.attr("block_y"), ctx.attr("block_x")),
                       padding=(ctx.attr("padding_y", 0), ctx.attr("padding_x", 0)),
                       stride=(ctx.attr("stride_y", 1), ctx.attr("stride_x", 1)))
    ctx.set_output("Out", patches.transpose(1, 2))


@register_op("row_conv")
def row_conv_kernel(ctx):
    """Lookahead row convolution (DeepSpeech2): out[t] = Σ_{i<k} x[t+i]·w[i]
    per feature. Dense X [N, T, D]; on a LoD X [capacity, D] the window
    stops at its sequence's end (RowConvLayer walks each sequence)."""
    x_in = ctx.input("X")
    w = _data(ctx.input("Filter"))
    k = w.shape[0]
    if isinstance(x_in, LoDArray):
        x, ids = x_in.data, x_in.seq_ids
        cap = x.shape[0]
        xp = F.pad(x, (0, 0, 0, k - 1))
        idp = F.pad(ids, (0, k - 1), value=-2)
        out = torch.zeros_like(x)
        for i in range(k):
            same = (idp[i:i + cap] == ids)[:, None].to(x.dtype)
            out = out + xp[i:i + cap] * same * w[i][None, :]
        ctx.set_output("Out", x_in.with_data(out))
        return
    t = x_in.shape[1]
    xp = F.pad(x_in, (0, 0, 0, k - 1))
    out = torch.zeros_like(x_in)
    for i in range(k):
        out = out + xp[:, i:i + t] * w[i][None, None, :]
    ctx.set_output("Out", out)


@register_op("conv_shift")
def conv_shift_kernel(ctx):
    """Circular convolution (ConvShiftLayer): X [N, D], Y [N, K] (K odd),
    out[n, d] = Σ_j Y[n, j]·X[n, (d + j - K//2) mod D]."""
    x, y = _data(ctx.input("X")), _data(ctx.input("Y"))
    k = y.shape[1]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + y[:, j:j + 1] * torch.roll(x, k // 2 - j, dims=1)
    ctx.set_output("Out", out)


# ----------------------------------------------------------------- random ---
def sample_ids(probs, gen):
    """One column a row, drawn with probability proportional to `probs`
    (jax.random.categorical's Gumbel-max on log p), from `gen`."""
    u = torch.rand(probs.shape, generator=gen, device=gen.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return (torch.log(probs.float().clamp(min=1e-20)) + gumbel).argmax(-1).to(torch.int32)


@register_op("sampling_id", runs_once=True)
def sampling_id_kernel(ctx):
    ctx.set_output("Out", sample_ids(_data(ctx.input("X")), ctx.generator()))


# --------------------------------------------------------------- factored ---
def _dot32(a, b):
    """a @ b accumulated and returned in f32, as the JAX ops'
    preferred_element_type=f32 without a cast back."""
    return torch.matmul(a.float(), b.float())


@register_op("factorization_machine")
def factorization_machine_kernel(ctx):
    """The second-order FM term ½·Σ((xV)² - x²V²) [N, 1]."""
    x, v = _data(ctx.input("X")), _data(ctx.input("Factor"))
    xv = _dot32(x, v)
    ctx.set_output("Out", 0.5 * (xv * xv - _dot32(x * x, v * v)).sum(-1, keepdim=True))


@register_op("bilinear_tensor_product")
def bilinear_tensor_product_kernel(ctx):
    """TensorLayer: out[n, k] = x[n] W_k y[n] (+ bias)."""
    x, y = _data(ctx.input("X")), _data(ctx.input("Y"))
    out = torch.einsum("nd,kde,ne->nk", x, _data(ctx.input("Weight")), y)
    if ctx.has_input("Bias"):
        out = out + _data(ctx.input("Bias")).reshape(1, -1)
    ctx.set_output("Out", out)


@register_op("selective_fc")
def selective_fc_kernel(ctx):
    """SelectiveFullyConnectedLayer: fc, its output masked to each row's
    selected columns (dense mask)."""
    out = _dot32(_data(ctx.input("X")), _data(ctx.input("W")))
    if ctx.has_input("Bias"):
        out = out + _data(ctx.input("Bias")).reshape(1, -1)
    if ctx.has_input("Mask"):
        out = out * _data(ctx.input("Mask"))
    ctx.set_output("Out", out)


# ---------------------------------------------------------------- 3-D ops ---
@register_op("conv3d")
def conv3d_kernel(ctx):
    """Conv3DLayer, NCDHW: cuDNN's convolution, in the amp dtype under amp
    and back in the input's dtype (TF32 off, as the Executor sets it)."""
    x = _data(ctx.input("Input"))
    xc, wc = amp.cast_inputs(ctx, x, _data(ctx.input("Filter")))
    out = F.conv3d(xc, wc, stride=tuple(ctx.attr("strides", (1, 1, 1))),
                   padding=tuple(ctx.attr("paddings", (0, 0, 0))),
                   groups=ctx.attr("groups", 1)).to(x.dtype)
    if ctx.has_input("Bias"):
        out = out + _data(ctx.input("Bias")).reshape(1, -1, 1, 1, 1)
    ctx.set_output("Output", out)


@register_op("pool3d")
def pool3d_kernel(ctx):
    """Max or average pooling over NCDHW windows; padding never wins a max
    and is not counted in an average's divisor, as the JAX op's
    reduce_window counts it."""
    x = _data(ctx.input("X"))
    ks = tuple(ctx.attr("ksize"))
    stride = tuple(ctx.attr("strides", ks))
    pad = tuple(ctx.attr("paddings", (0, 0, 0)))
    if ctx.attr("pooling_type", "max") == "max":
        out = F.max_pool3d(x, ks, stride, pad)
    else:
        out = F.avg_pool3d(x, ks, stride, pad, count_include_pad=False)
    ctx.set_output("Out", out)


# ------------------------------------------------------------- roi / spp ---
def roi_bins(rois, ph: int, pw: int, scale: float, h: int, w: int):
    """Each ROI's bins as membership masks: ([R, ph, H], [R, pw, W]) bool,
    the reference ROIPoolLayer's floor/ceil windows (they may overlap)
    clipped to the rounded box."""
    def axis(lo_c, hi_c, bins, n):
        lo = torch.round(lo_c * scale).long()
        hi = torch.round(hi_c * scale).long()
        size = (hi - lo + 1).clamp(min=1)[:, None]
        b = torch.arange(bins, device=rois.device)[None, :]
        start = lo[:, None] + torch.div(b * size, bins, rounding_mode="floor")
        end = lo[:, None] - torch.div(-(b + 1) * size, bins, rounding_mode="floor")
        p = torch.arange(n, device=rois.device)[None, None, :]
        in_box = (p >= lo[:, None, None]) & (p <= hi[:, None, None])
        return (p >= start[..., None]) & (p < end[..., None]) & in_box

    return axis(rois[:, 2], rois[:, 4], ph, h), axis(rois[:, 1], rois[:, 3], pw, w)


class _RoiMaxPool(torch.autograd.Function):
    """Max over each (ROI, bin) window, one bin at a time: never the JAX
    op's [R, ph, pw, C, H, W] mask. Backward recomputes each bin's tied
    maxima and splits the bin's gradient evenly among them, as JAX's max
    reduction does; an empty bin is 0 and takes no gradient."""

    @staticmethod
    def forward(ctx, img, in_y, in_x):  # img [R, C, H, W], ROI by ROI
        r, c = img.shape[:2]
        ph, pw = in_y.shape[1], in_x.shape[1]
        out = img.new_zeros((r, c, ph, pw))
        neg = img.new_full((), float("-inf"))
        for i in range(ph):
            for j in range(pw):
                m = in_y[:, i, :, None] & in_x[:, j, None, :]  # [R, H, W]
                out[:, :, i, j] = torch.where(m[:, None], img, neg).amax((2, 3))
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
        ctx.save_for_backward(img, in_y, in_x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        img, in_y, in_x, out = ctx.saved_tensors
        grad = torch.zeros_like(img)
        for i in range(in_y.shape[1]):
            for j in range(in_x.shape[1]):
                m = (in_y[:, i, :, None] & in_x[:, j, None, :])[:, None]  # [R, 1, H, W]
                tied = m & (img == out[:, :, i, j, None, None])
                count = tied.sum((2, 3), keepdim=True).clamp(min=1).to(img.dtype)
                grad = grad + torch.where(tied, g[:, :, i, j, None, None] / count,
                                          torch.zeros((), dtype=img.dtype, device=img.device))
        return grad, None, None


@register_op("roi_pool")
def roi_pool_kernel(ctx):
    """ROIPoolLayer: each ROI (batch index, x1, y1, x2, y2 in image
    coordinates) max-pooled into a [ph, pw] grid: [R, C, ph, pw]. Each
    ROI's image is taken by a one-hot product with the batch, so the
    backward adds the ROIs of one image without atomics."""
    x = _data(ctx.input("X"))
    rois = _data(ctx.input("ROIs"))
    n, c, h, w = x.shape
    in_y, in_x = roi_bins(rois, ctx.attr("pooled_height"), ctx.attr("pooled_width"),
                          ctx.attr("spatial_scale", 1.0), h, w)
    pick = (rois[:, 0].long()[:, None] == torch.arange(n, device=x.device)[None, :]).to(x.dtype)
    img = torch.matmul(pick, x.reshape(n, -1)).reshape(-1, c, h, w)
    ctx.set_output("Out", _RoiMaxPool.apply(img, in_y, in_x))


def _spp_edges(dim: int, bins: int):
    """Each bin's [lo, hi) along an axis of `dim`: floor and ceil windows of
    at least one pixel, as the reference computes them."""
    lo = [min((i * dim) // bins, dim - 1) for i in range(bins)]
    hi = [max(-(-((i + 1) * dim) // bins), lo[i] + 1) for i in range(bins)]
    return lo, [min(v, dim) if v > lo[i] else lo[i] + 1 for i, v in enumerate(hi)]


@register_op("spp")
def spp_kernel(ctx):
    """Spatial pyramid pooling: the [2^l x 2^l] grids for l < pyramid_height
    pooled (max or average) and concatenated (SpatialPyramidPoolLayer)."""
    x = _data(ctx.input("X"))
    max_pool = ctx.attr("pooling_type", "max") == "max"
    outs = []
    for level in range(ctx.attr("pyramid_height", 3)):
        bins = 2 ** level
        ylo, yhi = _spp_edges(x.shape[2], bins)
        xlo, xhi = _spp_edges(x.shape[3], bins)
        for by in range(bins):
            for bx in range(bins):
                win = x[:, :, ylo[by]:yhi[by], xlo[bx]:xhi[bx]]
                outs.append(win.amax((2, 3)) if max_pool else win.mean((2, 3)))
    ctx.set_output("Out", torch.cat(outs, 1))
