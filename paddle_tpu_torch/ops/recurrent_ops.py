"""The recurrent groups: `recurrent_group` and `nested_recurrent_group`
(paddle_tpu/ops/recurrent_ops.py:57, 147), with `_build_carries` (:21).

The JAX package traces the step sub-block once into a `lax.scan` over the
time-major dense form of the inputs. Here the step runs eagerly, frame by
frame: a Python loop over T frames runs the sub-block through the block
runner (`ctx.executor.run_ops`) on a fresh env over the enclosing one, so
the step closes over the parameters and every other value of the outer
block. Past each sequence's end the memories freeze (`torch.where` on the
frame's mask), so the final memory is each sequence's last state, as the
reference's frame machinery gives it (RecurrentGradientMachine.h:342, 428).
The gradient is torch autograd's through the frames.

The loop reads nothing back to the host: T is the op's `max_len` (or the
batch's capacity), a shape. A step that runs a group can be captured as
one CUDA graph (core/graph.py). A dropout in the step draws from the run's
generator once a frame, a fresh mask each frame; the op's `runs_once` rule
says so to the remat segmenter (core/registry.py `sub_blocks_run_once`).
"""

from __future__ import annotations

import torch

from ..core import registry
from ..core.lod import LoDArray
from ..core.registry import register_op
from .generation_ops import step_env
from .math_ops import _data, _torch_dtype


def _build_carries(ctx, boots, B: int, device):
    """The memories' first values from the op's mem_* attrs: a boot
    variable where one is given (its batch checked against B), else
    `init_value` over [B] + shape in the memory's dtype."""
    carries = []
    boot_it = iter(boots)
    for has_boot, shape, init, dt in zip(ctx.attr("mem_has_boot"), ctx.attr("mem_shape"),
                                         ctx.attr("mem_init_value"), ctx.attr("mem_dtype")):
        if has_boot:
            bv = _data(next(boot_it))
            if bv.shape[0] != B:
                raise ValueError(f"memory boot batch {bv.shape[0]} != sequence batch {B}")
            carries.append(bv)
        else:
            carries.append(torch.full((B,) + tuple(shape), init, dtype=_torch_dtype(dt),
                                      device=device))
    return carries


def _frozen(m, new, old):
    """`new` where the frame's mask `m` [B] holds, else `old`."""
    return torch.where(m.reshape((m.shape[0],) + (1,) * (new.dim() - 1)), new, old)


def run_frames(ctx, frames, mask, carries, feeds):
    """The step sub-block once a frame. `feeds(env, t)` binds frame t's
    inputs; `mask` [T, B] freezes the memories. Returns (final memories,
    the step outputs stacked [T, B, ...])."""
    runner = ctx.executor
    block = runner.program.blocks[ctx.attr("sub_block")]
    outer = step_env(ctx.env)
    mem_inner, mem_update = ctx.attr("mem_inner"), ctx.attr("mem_update")
    out_inner = ctx.attr("out_inner")
    outs = [[] for _ in out_inner]
    for t in range(frames):
        env = dict(outer)
        feeds(env, t)
        env.update(zip(mem_inner, carries))
        runner.run_ops(block.ops, env, block)
        carries = [_frozen(mask[t], _data(env[u]), c) for u, c in zip(mem_update, carries)]
        for acc, o in zip(outs, out_inner):
            acc.append(_data(env[o]))
    return carries, [torch.stack(o) for o in outs]


def _set_final(ctx, final) -> None:
    for i, f in enumerate(final[:len(ctx.op.outputs.get("FinalMem", []))]):
        ctx.set_output("FinalMem", f, i)


@register_op("recurrent_group", runs_once=registry.sub_blocks_run_once)
def recurrent_group_kernel(ctx):
    """The step over T = max_len (or the capacity) frames of the
    time-major inputs (`LoDArray.to_batch`); a token counts where every
    input has one. is_reverse flips the inputs and the mask, then the
    outputs back."""
    seqs = ctx.inputs("Seq")
    if not seqs or not isinstance(seqs[0], LoDArray):
        raise TypeError("recurrent_group inputs must be LoDArray sequences")
    first = seqs[0]
    for s in seqs[1:]:
        if s.capacity != first.capacity or s.max_seqs != first.max_seqs:
            raise ValueError(
                "recurrent_group step inputs have different LoD capacities: "
                f"{s.capacity}x{s.max_seqs} vs {first.capacity}x{first.max_seqs}")
    max_len = ctx.attr("max_len") or first.capacity
    xs, mask = [], None
    for s in seqs:
        b, m = s.to_batch(max_len)
        xs.append(b)
        mask = m if mask is None else mask & m
    reverse = ctx.attr("is_reverse", False)
    if reverse:
        xs = [x.flip(0) for x in xs]
        mask = mask.flip(0)
    carries = _build_carries(ctx, ctx.inputs("Boot"), first.max_seqs, first.device)
    seq_inner = ctx.attr("seq_inner")

    def feeds(env, t):
        env.update((name, x[t]) for name, x in zip(seq_inner, xs))

    final, outs = run_frames(ctx, mask.shape[0], mask, carries, feeds)
    if reverse:
        outs = [o.flip(0) for o in outs]
        mask = mask.flip(0)
    for i, o in enumerate(outs):
        ctx.set_output("Out", LoDArray.from_batch(o, mask, first), i)
    _set_final(ctx, final)


def _segment_extreme(values, ids, num: int, mode: str):
    """jax.ops.segment_min/max of int32 `values` over `num` segments: an
    empty segment holds the JAX identity (int32's max for min, its min for
    max)."""
    info = torch.iinfo(torch.int32)
    fill = info.max if mode == "amin" else info.min
    base = torch.full((num,), fill, dtype=torch.int32, device=values.device)
    return base.scatter_reduce(0, ids.long(), values, mode, include_self=False)


def _lod_from_lengths(lengths, capacity: int, like_data, trailing, num_seqs):
    """An empty LoDArray of the given per-sequence lengths."""
    dev = lengths.device
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(lengths.long(), 0)])
    pos = torch.arange(capacity, device=dev)
    seq_ids = torch.searchsorted(offsets, pos, right=True) - 1
    seq_ids = torch.where(pos < offsets[-1], seq_ids, -1).to(torch.int32)
    data = torch.zeros((capacity,) + tuple(trailing), dtype=like_data.dtype, device=dev)
    return LoDArray(data, seq_ids, lengths.to(torch.int32), num_seqs)


def _sub_layout(sq: LoDArray, S: int, L: int):
    """The gather map of one 2-level input from its own (seq_ids,
    sub_seq_ids): (flat [S, B, L] token indices, token mask [S, B, L],
    sub-sequences a sequence [B]), in int32 as the JAX op computes it."""
    B, C = sq.max_seqs, sq.capacity
    G = C  # each sub-sequence holds a token: the capacity bounds their count
    dev = sq.device
    i32 = torch.int32
    valid_tok = sq.sub_seq_ids >= 0
    sub_clip = torch.where(valid_tok, sq.sub_seq_ids, 0).long()
    sub_len = torch.zeros(G, dtype=i32, device=dev).index_add(0, sub_clip, valid_tok.to(i32))
    tok_pos = torch.arange(C, dtype=i32, device=dev)
    sub_start = _segment_extreme(torch.where(valid_tok, tok_pos, C), sub_clip, G, "amin")
    seq_of_sub = _segment_extreme(torch.where(valid_tok, sq.seq_ids, -1), sub_clip, G, "amax")
    sub_valid = sub_len > 0
    owner = torch.where(sub_valid, seq_of_sub, 0).long()
    num_subs = torch.zeros(B, dtype=i32, device=dev).index_add(0, owner, sub_valid.to(i32))
    first_sub = _segment_extreme(
        torch.where(sub_valid, torch.arange(G, dtype=i32, device=dev), G), owner, B, "amin")
    first_sub = torch.where(num_subs > 0, first_sub, 0)
    b_idx = torch.arange(B, device=dev)[None, :, None]
    s_idx = torch.arange(S, dtype=i32, device=dev)[:, None, None]
    l_idx = torch.arange(L, dtype=i32, device=dev)[None, None, :]
    g = torch.clamp(first_sub[b_idx] + s_idx, 0, G - 1).long()  # [S, B, 1]
    # int32 as the JAX op: an empty sub-sequence's start (int32's max)
    # wraps past the end, as it does there, and its tokens are masked
    flat = torch.clamp(sub_start[g] + l_idx, 0, C - 1).long()  # [S, B, L]
    tok_mask = (s_idx < num_subs[b_idx]) & (l_idx < sub_len[g])
    return flat, tok_mask, num_subs


@register_op("nested_recurrent_group", runs_once=registry.sub_blocks_run_once)
def nested_recurrent_group_kernel(ctx):
    """The outer recurrence over the sub-sequences of 2-level inputs
    (RecurrentGradientMachine::createInFrameInfo_subseq): frame t of
    sequence b is its t-th sub-sequence, densified to [B, max_sublen, ...]
    with its token mask. A sequence with more than max_subseqs
    sub-sequences and a sub-sequence longer than max_sublen are cut. The
    outputs form a 1-level sequence of one token a sub-sequence."""
    seqs = ctx.inputs("Seq")
    first = seqs[0]
    if first.sub_seq_ids is None:
        raise ValueError("nested_recurrent_group needs a 2-level LoDArray "
                         "(built with LoDArray.from_nested_sequences)")
    S, L = ctx.attr("max_subseqs"), ctx.attr("max_sublen")
    B, C = first.max_seqs, first.capacity
    subs, tok_mask, num_subs = [], None, None
    for sq in seqs:
        if sq.capacity != C or sq.max_seqs != B:
            raise ValueError("nested step inputs must share one LoD layout")
        if sq.sub_seq_ids is None:
            raise ValueError("nested_recurrent_group inputs must all be 2-level LoDArrays")
        flat, tm, ns = _sub_layout(sq, S, L)
        subs.append(sq.data[flat])  # [S, B, L, ...]
        tok_mask = tm if tok_mask is None else tok_mask & tm
        num_subs = ns if num_subs is None else torch.minimum(num_subs, ns)
    zero = torch.zeros((), dtype=first.data.dtype, device=first.device)
    subs = [torch.where(tok_mask.reshape(tok_mask.shape + (1,) * (d.dim() - 3)), d, zero)
            for d in subs]
    step_mask = torch.arange(S, device=first.device)[:, None] < num_subs[None, :]  # [S, B]
    carries = _build_carries(ctx, ctx.inputs("Boot"), B, first.device)
    seq_inner, seq_inner_mask = ctx.attr("seq_inner"), ctx.attr("seq_inner_mask")

    def feeds(env, t):
        env.update((name, d[t]) for name, d in zip(seq_inner, subs))
        env.update((name, tok_mask[t]) for name in seq_inner_mask)

    final, outs = run_frames(ctx, S, step_mask, carries, feeds)
    out_lens = torch.clamp(num_subs, max=S)
    for i, o in enumerate(outs):
        like = _lod_from_lengths(out_lens, B * S, o, o.shape[2:], first.num_seqs)
        ctx.set_output("Out", LoDArray.from_batch(o, step_mask, like), i)
    _set_final(ctx, final)
