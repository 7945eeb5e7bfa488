"""Sequence (LoD) op kernels of the inference slice: sequence_concat and
sequence_first_step (paddle_tpu/ops/sequence_ops.py:111,121)."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op


def segment_reduce(x: LoDArray, mode: str):
    """[capacity, ...] → [max_seqs, ...] per-sequence reduction. Only the
    mode the ported ops use is here; an absent sequence reads slot 0."""
    if mode == "first":
        idx = x.offsets[:-1].long().clamp(0, x.capacity - 1)
        return x.data[idx]
    raise NotImplementedError(f"segment_reduce mode {mode!r} is not ported yet")


@register_op("sequence_concat")
def sequence_concat_kernel(ctx):
    """Feature-axis concat of LoD inputs with identical lod."""
    xs = ctx.inputs("X")
    ctx.set_output("Out", xs[0].with_data(torch.cat([x.data for x in xs], dim=-1)))


@register_op("sequence_first_step")
def sequence_first_step_kernel(ctx):
    ctx.set_output("Out", segment_reduce(ctx.input("X"), "first"))
