"""Tensor-manipulation op kernels (paddle_tpu/ops/misc_ops.py), cut to
`crop` (:103), which slices the transformer's learned position table to
the sequence length."""

from __future__ import annotations

from ..core.lod import LoDArray
from ..core.registry import register_op


@register_op("crop")
def crop_kernel(ctx):
    """x[offsets : offsets + shape] along every axis, each offset clamped so
    the slice lies inside x, as lax.dynamic_slice clamps it."""
    x = ctx.input("X")
    x = x.data if isinstance(x, LoDArray) else x
    index = []
    for dim, off, size in zip(x.shape, ctx.attr("offsets"), ctx.attr("shape")):
        start = min(max(int(off), 0), dim - int(size))
        index.append(slice(start, start + int(size)))
    ctx.set_output("Out", x[tuple(index)])
