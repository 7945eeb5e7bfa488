"""Sequence (LoD) op kernels: sequence_concat, sequence_first_step,
sequence_pool and sequence_conv (paddle_tpu/ops/sequence_ops.py:52, 111,
121, 291), with `segment_reduce` (:25) in every mode of the JAX
package's."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op


def segment_reduce(x: LoDArray, mode: str):
    """[capacity, ...] → [max_seqs, ...] per-sequence reduction, padding
    slots reduced into a dump segment past the last sequence. An absent
    sequence sums to 0 under `sum`, `average` and `sqrt` (its count taken
    as 1), reads -inf under `max` and +inf under `min` (sequence_pool
    zeroes it), slot 0 under `first` and the slot before its offset under
    `last` (the padded-flat layout's clamp). `max` and `min` split a
    segment's gradient evenly among the elements tied at its extremum, as
    jax.ops.segment_max's does."""
    if mode in ("sum", "average", "sqrt", "max", "min"):
        ids = torch.where(x.seq_ids >= 0, x.seq_ids, x.max_seqs).long()
        shape = (x.max_seqs + 1,) + tuple(x.data.shape[1:])
        if mode in ("max", "min"):
            fill = float("-inf") if mode == "max" else float("inf")
            out = torch.full(shape, fill, dtype=x.data.dtype, device=x.device)
            idx = ids.reshape((-1,) + (1,) * (x.data.dim() - 1)).expand_as(x.data)
            return out.scatter_reduce(0, idx, x.data, "amax" if mode == "max" else "amin",
                                      include_self=False)[:-1]
        out = torch.zeros(shape, dtype=x.data.dtype, device=x.device)
        s = out.index_add(0, ids, x.data)[:-1]
        if mode == "sum":
            return s
        cnt = x.lengths.clamp(min=1).to(s.dtype)
        if mode == "sqrt":
            cnt = cnt.sqrt()
        return s / cnt.reshape((-1,) + (1,) * (s.dim() - 1))
    if mode == "first":
        idx = x.offsets[:-1].long().clamp(0, x.capacity - 1)
        return x.data[idx]
    if mode == "last":
        idx = (x.offsets[1:].long() - 1).clamp(0, x.capacity - 1)
        return x.data[idx]
    raise NotImplementedError(f"sequence_pool mode {mode!r}")


@register_op("sequence_concat")
def sequence_concat_kernel(ctx):
    """Feature-axis concat of LoD inputs with identical lod."""
    xs = ctx.inputs("X")
    ctx.set_output("Out", xs[0].with_data(torch.cat([x.data for x in xs], dim=-1)))


@register_op("sequence_first_step")
def sequence_first_step_kernel(ctx):
    ctx.set_output("Out", segment_reduce(ctx.input("X"), "first"))


@register_op("sequence_pool")
def sequence_pool_kernel(ctx):
    """Per-sequence pooling, absent sequences (past num_seqs) zeroed."""
    x = ctx.input("X")
    out = segment_reduce(x, ctx.attr("pooltype", "sum").lower())
    valid = torch.arange(x.max_seqs, device=x.device) < x.num_seqs
    valid = valid.reshape((-1,) + (1,) * (out.dim() - 1))
    ctx.set_output("Out", torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                                              device=out.device)))


@register_op("sequence_conv")
def sequence_conv_kernel(ctx):
    """Context-window convolution over a ragged batch (sequence_conv_op.cc,
    ContextProjection): out[t] = concat_{i<L} x[t + start + i] @ Filter,
    a window position outside t's sequence read as zero; then Bias, and
    the padding slots zeroed. As the JAX op, the product promotes its
    operands (x's dtype and the f32 Filter) and emits f32."""
    x = ctx.input("X")
    w = ctx.input("Filter")
    w = w.data if isinstance(w, LoDArray) else w
    length = ctx.attr("context_length")
    start = ctx.attr("context_start", -(length // 2))
    cap = x.capacity
    pos = torch.arange(cap, device=x.device)
    zero = torch.zeros((), dtype=x.data.dtype, device=x.device)
    cols = []
    for i in range(length):
        at = pos + (start + i)
        src = at.clamp(0, cap - 1)
        same = (at >= 0) & (at < cap) & (x.seq_ids[src] == x.seq_ids)
        cols.append(torch.where(same[:, None], x.data[src], zero))
    feat = torch.cat(cols, dim=-1)  # [cap, L*D]
    dt = torch.promote_types(feat.dtype, w.dtype)
    out = torch.matmul(feat.to(dt), w.to(dt)).float()
    if ctx.has_input("Bias"):
        b = ctx.input("Bias")
        out = out + (b.data if isinstance(b, LoDArray) else b).reshape(1, -1)
    out = torch.where(x.token_mask[:, None], out, torch.zeros((), device=out.device))
    ctx.set_output("Out", x.with_data(out))
