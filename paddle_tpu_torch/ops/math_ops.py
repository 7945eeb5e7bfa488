"""Math op kernels (paddle_tpu/ops/math_ops.py), every op of that module:
the products (`mul`, `matmul`), the elementwise family (:94-112), the
reductions (:118-152), the shape ops (`reshape`, `transpose`, `concat`,
`split`, `expand`, `slice`), `scale`, `clip`, `cast`, `sign`, the norm
clips, `squared_l2_norm`, `top_k`, `lookup_table`, `fill_constant`,
`assign`, `increment`, `argmax` and the random ops, on torch tensors.
The matrix products go to torch.matmul, as the JAX package leaves them to
XLA. The random ops draw from the run's torch.Generator: the same
distributions as the JAX package's, not the same numbers."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import amp
from ..core.lod import LoDArray
from ..core.registry import SPARSE_KEY, register_op
from .activation_ops import rounded


def _data(x):
    return x.data if isinstance(x, LoDArray) else x


def _like(x, data):
    return x.with_data(data) if isinstance(x, LoDArray) else data


def dot(a, b):
    """a @ b in a's dtype, accumulated in f32 — the JAX package's
    `jnp.dot(a, b, preferred_element_type=f32).astype(a.dtype)`. On the
    card this holds for bf16 because the Executor turns off cuBLAS's
    reduced-precision bf16 reduction; the CPU's bf16 GEMM accumulates in
    f32."""
    return torch.matmul(a, b.to(a.dtype))


@register_op("mul")
def mul_kernel(ctx):
    """Flattens X to 2-D by x_num_col_dims, then one GEMM."""
    x_in = ctx.input("X")
    x, y = _data(x_in), _data(ctx.input("Y"))
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xd]), -1)
    y2 = y.reshape(math.prod(ys[:yd]), -1)
    x2, y2 = amp.cast_inputs(ctx, x2, y2)
    out = dot(x2, y2).reshape(xs[:xd] + ys[yd:])
    ctx.set_output("Out", _like(x_in, out))


@register_op("matmul")
def matmul_kernel(ctx):
    """Batched matmul with transpose flags; the int8 converter rewrites a
    2-D site whose Y is a weight to `quantized_matmul`."""
    x, y = _data(ctx.input("X")), _data(ctx.input("Y"))
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    x, y = amp.cast_inputs(ctx, x, y)
    ctx.set_output("Out", dot(x, y))


def _broadcast_y(x, y, axis):
    """y's shape must match a contiguous slice of x's starting at `axis`."""
    if y.dim() == x.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * (x.dim() - axis - y.dim()))


def _make_elementwise(name, fn):
    """X fn Y, Y broadcast from `axis`; under amp an f32 operand meeting an
    amp-dtype one is cast down (amp.harmonize). X's LoD is kept."""
    def kernel(ctx):
        x, y = ctx.input("X"), ctx.input("Y")
        xd, yd = _data(x), _data(y)
        yd = _broadcast_y(xd, yd, ctx.attr("axis", -1))
        xd, yd = amp.harmonize(ctx, xd, yd)
        ctx.set_output("Out", _like(x, fn(xd, yd)))

    register_op(name)(kernel)


_make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.true_divide)
_make_elementwise("elementwise_max", torch.maximum)
_make_elementwise("elementwise_min", torch.minimum)
_make_elementwise("elementwise_pow", torch.pow)


def _sum_dtype(x, out):
    """jnp.sum's dtype: an integer or bool input sums to int32 (x64 off),
    where torch.sum gives int64."""
    return out if x.is_floating_point() else out.to(torch.int32)


def _make_reduce(name, fn):
    """Over `dim` (an int or a list; default 0), every axis with
    `reduce_all`; `keep_dim` keeps the reduced axes as 1."""
    def kernel(ctx):
        x = _data(ctx.input("X"))
        dim = ctx.attr("dim", 0)
        if ctx.attr("reduce_all", False) or dim is None:
            dim = tuple(range(x.dim()))
        elif isinstance(dim, (list, tuple)):
            dim = tuple(dim)
        ctx.set_output("Out", fn(x, dim, bool(ctx.attr("keep_dim", False))))

    register_op(name)(kernel)


def _mean(x, dim, keep):
    """jnp.mean: an integer input's mean is f32."""
    return (x if x.is_floating_point() else x.float()).mean(dim, keepdim=keep)


_make_reduce("reduce_sum", lambda x, d, k: _sum_dtype(x, x.sum(d, keepdim=k)))
_make_reduce("reduce_mean", _mean)
_make_reduce("reduce_max", lambda x, d, k: torch.amax(x, d, keepdim=k))
_make_reduce("reduce_min", lambda x, d, k: torch.amin(x, d, keepdim=k))


@register_op("transpose")
def transpose_kernel(ctx):
    ctx.set_output("Out", _data(ctx.input("X")).permute(list(ctx.attr("axis"))))


@register_op("split")
def split_kernel(ctx):
    """Into `sections` (their sizes) or `num` equal parts along `axis`."""
    x = _data(ctx.input("X"))
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections")
    if sections:
        parts = torch.split(x, list(sections), dim=axis)
    else:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} does not divide "
                             f"into {num} equal parts")
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    for i, p in enumerate(parts):
        ctx.set_output("Out", p, idx=i)


@register_op("expand")
def expand_kernel(ctx):
    """jnp.tile by `expand_times`."""
    ctx.set_output("Out", torch.tile(_data(ctx.input("X")), tuple(ctx.attr("expand_times"))))


@register_op("slice")
def slice_kernel(ctx):
    """x[starts:ends] on `axes`, ends past the axis clamped as in numpy."""
    x = _data(ctx.input("X"))
    idx = [slice(None)] * x.dim()
    for ax, s, e in zip(ctx.attr("axes"), ctx.attr("starts"), ctx.attr("ends")):
        idx[ax] = slice(s, e)
    ctx.set_output("Out", x[tuple(idx)])


@register_op("clip")
def clip_kernel(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", _like(x, torch.clamp(_data(x), ctx.attr("min"), ctx.attr("max"))))


@register_op("cast")
def cast_kernel(ctx):
    """To `dtype` (a numpy name, or bfloat16); the LoD is kept."""
    x = ctx.input("X")
    ctx.set_output("Out", _like(x, _data(x).to(_torch_dtype(ctx.attr("dtype")))))


@register_op("clip_by_norm")
def clip_by_norm_kernel(ctx):
    """x · min(max_norm / max(‖x‖₂, 1e-12), 1), the norm in x's dtype
    (clip_by_norm_op.cc)."""
    x = _data(ctx.input("X"))
    norm = torch.sqrt(torch.square(x).sum())
    scale = torch.clamp(ctx.attr("max_norm") / torch.clamp(norm, min=1e-12), max=1.0)
    ctx.set_output("Out", x * scale)


@register_op("squared_l2_norm")
def squared_l2_norm_kernel(ctx):
    ctx.set_output("Out", torch.square(_data(ctx.input("X"))).sum())


@register_op("assign")
def assign_kernel(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("increment")
def increment_kernel(ctx):
    """x + step, the step cast to x's dtype: an int counter stays an int."""
    x = ctx.input("X")
    d = _data(x)
    step = ctx.attr("step", 1.0)
    step = rounded(step, d.dtype) if d.is_floating_point() else int(step)
    ctx.set_output("Out", _like(x, d + step))


@register_op("argmax")
def argmax_kernel(ctx):
    """Along `axis`, the first of tied maxima, as int32."""
    x = _data(ctx.input("X"))
    ctx.set_output("Out", torch.argmax(x, dim=ctx.attr("axis", -1)).to(torch.int32))


@register_op("top_k")
def top_k_kernel(ctx):
    """The k largest values along the last axis and their int32 indices,
    largest first (top_k_op.cc; `accuracy`'s first op)."""
    x = _data(ctx.input("X"))
    vals, idxs = torch.topk(x, ctx.attr("k", 1), dim=-1, largest=True, sorted=True)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idxs.to(torch.int32))


def _tape_lookup(op, env) -> bool:
    """A lookup of an is_sparse table, which records a site on the tape."""
    tape = env.get(SPARSE_KEY)
    return tape is not None and op.inputs["W"][0] in tape.params


@register_op("lookup_table", runs_once=_tape_lookup)
def lookup_table_kernel(ctx):
    """Embedding gather. Like the JAX kernel it emits the table's dtype
    (f32); the `mul` after it casts down under amp. A table that takes
    SelectedRows gradients (is_sparse) is gathered through the run's tape
    (core/sparse.py)."""
    w = ctx.input("W")
    ids = ctx.input("Ids")
    ids_data = _data(ids)
    if ids_data.dim() > 1 and ids_data.shape[-1] == 1:
        ids_data = ids_data[..., 0]
    if _tape_lookup(ctx.op, ctx.env):
        ctx.once()
        wname = ctx.op.inputs["W"][0]
        tape = ctx.env[SPARSE_KEY]
        rows = ids_data.long()
        if isinstance(ids, LoDArray):
            # padding tokens must not touch row 0: point them past the table
            rows = torch.where(ids.seq_ids >= 0, rows, w.shape[0])
        out = tape.gather(wname, w, rows)
    else:
        out = w[ids_data.long()]
    pad = ctx.attr("padding_idx")
    if pad is not None:
        out = torch.where((ids_data == pad)[..., None], torch.zeros((), dtype=out.dtype,
                                                                    device=out.device), out)
    ctx.set_output("Out", _like(ids, out))


@register_op("scale")
def scale_kernel(ctx):
    """x * scale + bias (the L2 decay's coeff·param, a learning-rate
    multiplier)."""
    x = ctx.input("X")
    ctx.set_output("Out", _like(x, _data(x) * ctx.attr("scale", 1.0) + ctx.attr("bias", 0.0)))


@register_op("concat")
def concat_kernel(ctx):
    """Along `axis`, dtypes promoted as jnp.concatenate promotes them (a
    generation step joins an f32 embedding and its memory)."""
    xs = [_data(x) for x in ctx.inputs("X")]
    ctx.set_output("Out", torch.cat(xs, dim=ctx.attr("axis", 0)))


@register_op("sign")
def sign_kernel(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", _like(x, torch.sign(_data(x))))


@register_op("clip_by_global_norm")
def clip_by_global_norm_kernel(ctx):
    """Scales every X[i] by min(max_norm / max(gnorm, 1e-12), 1), gnorm the
    joint L2 norm of all of them, summed in f32 (the gradients of the f32
    master parameters)."""
    xs = [_data(x) for x in ctx.inputs("X")]
    gnorm = torch.sqrt(sum(x.float().square().sum() for x in xs))
    scale = torch.clamp(ctx.attr("max_global_norm") / torch.clamp(gnorm, min=1e-12), max=1.0)
    for i, x in enumerate(xs):
        ctx.set_output("Out", x * scale.to(x.dtype), idx=i)


@register_op("mean")
def mean_kernel(ctx):
    """Loss-style reduction: a reduced-precision float input (bf16 under
    amp) accumulates and emits f32."""
    x = _data(ctx.input("X"))
    if x.is_floating_point() and x.dtype != torch.float32:
        x = x.float()
    ctx.set_output("Out", x.mean())


@register_op("sum")
def sum_kernel(ctx):
    """Adds its N inputs (sum_op.cc; the several-input fc's join), in
    input order; the output keeps the first input's LoD."""
    xs = ctx.inputs("X")
    out = _data(xs[0])
    for x in xs[1:]:
        out = out + _data(x)
    ctx.set_output("Out", _like(xs[0], out))


@register_op("reshape")
def reshape_kernel(ctx):
    """The data (a LoDArray's too) to `shape`, as a dense tensor."""
    ctx.set_output("Out", _data(ctx.input("X")).reshape(list(ctx.attr("shape"))))


def _torch_dtype(name):
    if str(name) == "bfloat16":  # no numpy dtype without ml_dtypes
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype


def _random_out(ctx, sample):
    """Draw in f32 on the generator's device, then cast to the op's dtype."""
    gen = ctx.generator()
    out = sample(tuple(ctx.attr("shape")), gen)
    ctx.set_output("Out", out.to(_torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("fill_constant")
def fill_constant_kernel(ctx):
    dev = ctx.device()
    ctx.set_output("Out", torch.full(tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
                                     dtype=_torch_dtype(ctx.attr("dtype", "float32")),
                                     device=dev))


@register_op("uniform_random", runs_once=True)
def uniform_random_kernel(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    _random_out(ctx, lambda shape, gen: torch.empty(
        shape, device=gen.device).uniform_(lo, hi, generator=gen))


@register_op("gaussian_random", runs_once=True)
def gaussian_random_kernel(ctx):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    _random_out(ctx, lambda shape, gen: torch.empty(
        shape, device=gen.device).normal_(mean, std, generator=gen))


@register_op("truncated_gaussian_random", runs_once=True)
def truncated_gaussian_random_kernel(ctx):
    """mean + std · z, z a standard normal truncated to [-2, 2]."""
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    _random_out(ctx, lambda shape, gen: mean + std * torch.nn.init.trunc_normal_(
        torch.empty(shape, device=gen.device), 0.0, 1.0, -2.0, 2.0, generator=gen))
