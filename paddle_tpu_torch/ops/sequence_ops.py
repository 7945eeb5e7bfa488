"""Sequence (LoD) op kernels (paddle_tpu/ops/sequence_ops.py), with
`segment_reduce` (:25) in every mode of the JAX package's:
sequence_pool, sequence_softmax, sequence_expand, sequence_concat,
sequence_first_step and sequence_last_step (:52-126), and the widened set
(:151-291): sequence_slice, sequence_reshape, sequence_reverse,
kmax_seq_score, sub_nested_seq, featmap_expand, eos_id and sequence_conv.
Every output keeps the padded-flat layout's invariant: padding slots
zero."""

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


def _dump_ids(x: LoDArray):
    """Each slot's sequence, padding in a dump segment past the last."""
    return torch.where(x.seq_ids >= 0, x.seq_ids, x.max_seqs).long()


def _zero_padding(keep, data):
    """`data` where the [capacity] bool `keep` holds, zero elsewhere."""
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


@register_op("sequence_softmax")
def sequence_softmax_kernel(ctx):
    """Softmax within each sequence (sequence_softmax_op.cc) of a
    [capacity] or [capacity, 1] input; padding slots zero. The shift by the
    sequence's max leaves the result unchanged and takes no gradient."""
    x = ctx.input("X")
    data = x.data
    squeeze = data.dim() == 2 and data.shape[1] == 1
    if squeeze:
        data = data[:, 0]
    ids = _dump_ids(x)
    data = torch.where(x.token_mask, data,
                       torch.full((), float("-inf"), dtype=data.dtype, device=data.device))
    seg_max = torch.full((x.max_seqs + 1,), float("-inf"), dtype=data.dtype,
                         device=data.device).scatter_reduce(0, ids, data.detach(), "amax",
                                                            include_self=False)
    e = _zero_padding(x.token_mask, torch.exp(data - seg_max[ids]))
    seg_sum = torch.zeros(x.max_seqs + 1, dtype=e.dtype, device=e.device).index_add(0, ids, e)
    out = e / torch.clamp(seg_sum[ids], min=1e-20)
    ctx.set_output("Out", x.with_data(out[:, None] if squeeze else out))


@register_op("sequence_expand")
def sequence_expand_kernel(ctx):
    """The rows of X (dense [max_seqs, ...] or a LoDArray's data), each
    broadcast over the tokens of Y's sequence of its index (ExpandLayer)."""
    x, y = ctx.input("X"), ctx.input("Y")
    rows = x.data if isinstance(x, LoDArray) else x
    out = rows[torch.clamp(y.seq_ids, 0, rows.shape[0] - 1).long()]
    ctx.set_output("Out", y.with_data(_zero_padding(y.token_mask, out)))


@register_op("sequence_concat")
def sequence_concat_kernel(ctx):
    """Feature-axis concat of LoD inputs with identical lod."""
    xs = ctx.inputs("X")
    ctx.set_output("Out", xs[0].with_data(torch.cat([x.data for x in xs], dim=-1)))


@register_op("sequence_first_step")
def sequence_first_step_kernel(ctx):
    ctx.set_output("Out", segment_reduce(ctx.input("X"), "first"))


@register_op("sequence_last_step")
def sequence_last_step_kernel(ctx):
    ctx.set_output("Out", segment_reduce(ctx.input("X"), "last"))


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


def _out_seq_structure(new_lengths, capacity: int):
    """(seq_ids, offsets) of a new padded-flat layout of the given
    per-sequence lengths over `capacity` slots, -1 past the tokens."""
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=new_lengths.device),
                         torch.cumsum(new_lengths, 0).to(torch.int32)])
    pos = torch.arange(capacity, device=new_lengths.device)
    ids = (pos[:, None] >= offsets[None, 1:]).sum(-1).to(torch.int32)
    return torch.where(pos < offsets[-1], ids, -1), offsets


def _int_vector(v):
    return (v.data if isinstance(v, LoDArray) else v).reshape(-1).to(torch.int32)


@register_op("sequence_slice")
def sequence_slice_kernel(ctx):
    """[offset, offset + length) of each sequence (SequenceSliceLayer),
    the per-sequence Offset and Length padded or cut to max_seqs; a slice
    past a sequence's end is cut there."""
    x = ctx.input("X")

    def fit(v):
        if v.shape[0] < x.max_seqs:
            return torch.nn.functional.pad(v, (0, x.max_seqs - v.shape[0]))
        return v[:x.max_seqs]

    off, length = fit(_int_vector(ctx.input("Offset"))), fit(_int_vector(ctx.input("Length")))
    new_len = torch.clamp(torch.minimum(length, x.lengths - off), min=0)
    new_len = new_len * (torch.arange(x.max_seqs, device=x.device) < x.num_seqs)
    ids, new_offsets = _out_seq_structure(new_len, x.capacity)
    sid = torch.clamp(ids, 0, x.max_seqs - 1).long()
    local = torch.arange(x.capacity, device=x.device) - new_offsets[sid]
    src = torch.clamp(x.offsets[sid] + off[sid] + local, 0, x.capacity - 1).long()
    ctx.set_output("Out", LoDArray(_zero_padding(ids >= 0, x.data[src]), ids, new_len,
                                   x.num_seqs))


@register_op("sequence_reshape")
def sequence_reshape_kernel(ctx):
    """The feature axis refactored to `new_dim` (SequenceReshapeLayer):
    each sequence's length scales by D / new_dim."""
    x = ctx.input("X")
    new_dim = ctx.attr("new_dim")
    d = x.data.shape[-1]
    new_cap = x.capacity * d // new_dim
    new_len = (x.lengths * d) // new_dim
    ids, _ = _out_seq_structure(new_len, new_cap)
    ctx.set_output("Out", LoDArray(x.data.reshape(new_cap, new_dim), ids, new_len, x.num_seqs))


@register_op("sequence_reverse")
def sequence_reverse_kernel(ctx):
    """Each sequence's tokens in reverse order, the layout kept."""
    x = ctx.input("X")
    pos = torch.arange(x.capacity, device=x.device)
    sid = torch.clamp(torch.where(x.seq_ids >= 0, x.seq_ids, 0), 0, x.max_seqs - 1).long()
    local = pos - x.offsets[sid]
    src = torch.clamp(x.offsets[sid] + x.lengths[sid] - 1 - local, 0, x.capacity - 1).long()
    ctx.set_output("Out", x.with_data(_zero_padding(x.seq_ids >= 0, x.data[src])))


@register_op("kmax_seq_score")
def kmax_seq_score_kernel(ctx):
    """The within-sequence indices of each sequence's `beam_size` highest
    scores, best first, -1 past its length (KmaxSeqScoreLayer): an int32
    [max_seqs, k]. Among equal scores the lower index comes first, as
    jax.lax.top_k orders them: a stable sort."""
    x = ctx.input("X")
    k = ctx.attr("beam_size", 1)
    dense, valid = x.with_data(x.data.reshape(x.capacity)).to_batch(time_major=False)
    masked = torch.where(valid, dense, torch.full((), float("-inf"), dtype=dense.dtype,
                                                  device=dense.device))
    idx = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :k]
    in_range = torch.gather(valid, 1, idx)
    ctx.set_output("Out", torch.where(in_range, idx, -1).to(torch.int32))


@register_op("sub_nested_seq")
def sub_nested_seq_kernel(ctx):
    """The sub-sequences of a 2-level input picked by their batch-wide
    index (Selection, int, -1 a pad), as a 1-level batch of one sequence a
    pick (SubNestedSequenceLayer)."""
    x = ctx.input("X")
    if x.sub_seq_ids is None:
        raise ValueError("sub_nested_seq requires a 2-level LoDArray input")
    sel = _int_vector(ctx.input("Selection"))
    n_sel, n_subs = sel.shape[0], x.capacity
    sub_ids = x.sub_seq_ids
    ones = (sub_ids >= 0).to(torch.int32)
    sub_len = torch.zeros(n_subs + 1, dtype=torch.int32, device=x.device).index_add(
        0, torch.where(sub_ids >= 0, sub_ids, n_subs).long(), ones)[:-1]
    sub_off = torch.cat([torch.zeros(1, dtype=torch.int32, device=x.device),
                         torch.cumsum(sub_len, 0).to(torch.int32)])
    sel_valid = sel >= 0
    sel_safe = torch.where(sel_valid, sel, 0).long()
    new_len = torch.where(sel_valid, sub_len[sel_safe], 0)
    ids, new_offsets = _out_seq_structure(new_len, x.capacity)
    sid = torch.clamp(ids, 0, n_sel - 1).long()
    local = torch.arange(x.capacity, device=x.device) - new_offsets[sid]
    src = torch.clamp(sub_off[sel_safe[sid]] + local, 0, x.capacity - 1).long()
    ctx.set_output("Out", LoDArray(_zero_padding(ids >= 0, x.data[src]), ids, new_len,
                                   sel_valid.to(torch.int32).sum()))


@register_op("featmap_expand")
def featmap_expand_kernel(ctx):
    """Each token's features repeated `num_filters` times
    (FeatureMapExpandLayer): tiled as a row ([cap, D] -> [cap, n·D]), or
    with as_row_vector=False each element n times in place."""
    x = ctx.input("X")
    n = ctx.attr("num_filters")
    d = x.data
    out = d.repeat(1, n) if ctx.attr("as_row_vector", True) else d.repeat_interleave(n, dim=-1)
    ctx.set_output("Out", x.with_data(out))


@register_op("eos_id")
def eos_id_kernel(ctx):
    """1.0 where a token's (first) id equals `eos_id` (EosIdCheckLayer)."""
    x = ctx.input("X")
    d = x.data if isinstance(x, LoDArray) else x
    out = (d.reshape(d.shape[0], -1)[:, :1] == ctx.attr("eos_id")).to(torch.float32)
    ctx.set_output("Out", x.with_data(out) if isinstance(x, LoDArray) else out)
