"""Tensor-manipulation op kernels (paddle_tpu/ops/misc_ops.py), cut to
`crop` (:103), which slices the transformer's learned position table to
the sequence length, and `cos_sim` (:142), the recommender's join."""

from __future__ import annotations

import torch

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


@register_op("cos_sim")
def cos_sim_kernel(ctx):
    """Row-wise cosine similarity over the last axis, times `scale`
    (CosSimLayer), its norms' product held at eps = 1e-8 or above."""
    x_in = ctx.input("X")
    x = x_in.data if isinstance(x_in, LoDArray) else x_in
    y = ctx.input("Y")
    y = y.data if isinstance(y, LoDArray) else y
    num = (x * y).sum(-1, keepdim=True)
    den = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * \
        torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    out = ctx.attr("scale", 1.0) * num / den.clamp(min=1e-8)
    ctx.set_output("Out", x_in.with_data(out) if isinstance(x_in, LoDArray) else out)
