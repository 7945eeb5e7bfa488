"""Math op kernels: mul, matmul, elementwise_add, mean, sum, reshape,
top_k, lookup_table, scale, sign, clip_by_global_norm, concat and the
startup program's fill_constant, uniform_random and gaussian_random
(paddle_tpu/ops/math_ops.py:35,67,108,118,128,155,264,274,207,228,245,168,
306,335,346), on torch tensors.
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


@register_op("elementwise_add")
def elementwise_add_kernel(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xd, yd = _data(x), _data(y)
    yd = _broadcast_y(xd, yd, ctx.attr("axis", -1))
    xd, yd = amp.harmonize(ctx, xd, yd)
    ctx.set_output("Out", _like(x, xd + yd))


@register_op("top_k")
def top_k_kernel(ctx):
    """The k largest values along the last axis and their int32 indices,
    largest first (top_k_op.cc; `accuracy`'s first op)."""
    x = _data(ctx.input("X"))
    vals, idxs = torch.topk(x, ctx.attr("k", 1), dim=-1, largest=True, sorted=True)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idxs.to(torch.int32))


@register_op("lookup_table")
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
    tape = ctx.env.get(SPARSE_KEY)
    wname = ctx.op.inputs["W"][0]
    if tape is not None and wname in tape.params:
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
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype


def _random_out(ctx, sample):
    """Draw in f32 on the generator's device, then cast to the op's dtype."""
    gen = ctx.generator()
    out = sample(tuple(ctx.attr("shape")), gen)
    ctx.set_output("Out", out.to(_torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("fill_constant")
def fill_constant_kernel(ctx):
    dev = ctx.generator().device
    ctx.set_output("Out", torch.full(tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
                                     dtype=_torch_dtype(ctx.attr("dtype", "float32")),
                                     device=dev))


@register_op("uniform_random")
def uniform_random_kernel(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    _random_out(ctx, lambda shape, gen: torch.empty(
        shape, device=gen.device).uniform_(lo, hi, generator=gen))


@register_op("gaussian_random")
def gaussian_random_kernel(ctx):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    _random_out(ctx, lambda shape, gen: torch.empty(
        shape, device=gen.device).normal_(mean, std, generator=gen))
