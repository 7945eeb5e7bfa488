"""Attention over [B, T, H, D] (paddle_tpu/ops/flash_ops.py): the plain
formula, the dispatcher and the `flash_attention` op.

A CUDA tensor goes to the hand-written flash-attention kernels
(ops/flash_kernels.py, csrc/flash_attn.cu), a CPU tensor to the plain
formula, which is the JAX package's `_reference` (flash_ops.py:35-48) op by
op: what its dispatcher runs off the TPU and its CPU tests hold the TPU
kernel to. The JAX package's eligibility rules (128-aligned T, a minimum
T, a score-bytes threshold, TPU block sizes and tuning overrides) choose
between its kernel and XLA; the kernels here take any T, D in {64, 128}
and K, V of Q's shape, and raise on anything else. So on the card the op
routes by shape before any launch (`kernel_takes`), as the JAX op routes
by `flash_eligible`: the shapes the kernels take go to them, every other
shape (another head dim, a cross-attention whose keys have another
length) to the plain formula on the card. Nothing falls back on an error.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import flash_kernels
from .activation_ops import rounded, softmax

NEG_INF = -1e30  # the masked score, as the JAX package's

# CUDA calls the routing rule sent to the plain formula in this process;
# chip_smoke.py reads it (the kernels count their own launches)
plain_routes = 0


def scaled_dot_product_attention(q, k, v, causal: bool = False):
    """[B, T, H, D] attention, the plain formula in q's dtype: the scores'
    einsum, the scale, where(mask, s, -1e30), jax.nn.softmax's formula and
    the einsum with v, each op rounding in bf16 where the JAX package's
    rounds (its constants rounded to the dtype first). Its gradient is
    autograd through it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / rounded(math.sqrt(q.shape[-1]), q.dtype)
    if causal:
        Tq, Tk = s.shape[-2:]
        mask = torch.arange(Tq, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)
        s = torch.where(mask, s, rounded(NEG_INF, q.dtype))
    return torch.einsum("bhqk,bkhd->bqhd", softmax(s, dim=-1), v)


def kernel_takes(q, k, v) -> bool:
    """The routing rule: the flash kernels take a head dim in HEAD_DIMS
    and K, V of Q's shape."""
    return q.shape[-1] in flash_kernels.HEAD_DIMS and k.shape == q.shape and v.shape == q.shape


def flash_attention(q, k, v, causal: bool = False):
    """[B, T, H, D] attention (K, V [B, Tk, H, D]): on the card the kernels
    where `kernel_takes` says so, else the plain formula; on the CPU the
    plain formula."""
    global plain_routes
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(q.shape)}")
    if q.device.type == "cuda":
        if kernel_takes(q, k, v):
            return flash_kernels.flash_fused(q, k, v, causal)
        plain_routes += 1
        return scaled_dot_product_attention(q, k, v, causal)
    if q.device.type == "cpu":
        return scaled_dot_product_attention(q, k, v, causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


@register_op("flash_attention")
def flash_attention_kernel(ctx):
    """Q/K/V are [B, T, E] packed multi-head projections; num_heads splits
    E into heads, a view of the contiguous projections
    (layers.multi_head_attention)."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    heads = ctx.attr("num_heads")
    B, T, E = q.shape
    if E % heads:
        raise ValueError(f"hidden dim {E} not divisible by heads {heads}")
    split = lambda x: x.reshape(B, x.shape[1], heads, E // heads)  # noqa: E731
    o = flash_attention(split(q), split(k), split(v), causal=ctx.attr("causal", True))
    ctx.set_output("Out", o.reshape(B, T, E))
