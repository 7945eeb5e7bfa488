"""Ring and Ulysses attention: sequence parallelism over an SP mesh axis
(paddle_tpu/parallel/ring_attention.py).

The JAX package runs both under shard_map on a global array whose T axis
is sharded. Here each rank of the axis holds its own shard: q, k and v are
[B, T/n, H, D], shard i the i-th run of T/n positions (`shard_sequence`
cuts a global tensor so, with the JAX package's divisibility error), and
the output is this rank's shard of the same layout.

- `ring_attention`: the query shard stays while the key/value shards go
  round the ring by send/recv, one hop a step, and the softmax is
  accumulated online (running max and denominator, the JAX body's
  formulas in f32), so no rank holds the [T, T] scores. send/recv carry no
  autograd, so the ring is a `torch.autograd.Function`: its backward runs
  the ring again from the saved log-sum-exp, each key/value shard
  travelling with the gradient accumulated for it until it is home.
  Blocks the causal mask hides wholly are skipped (they add exact zeros
  in the JAX body).
- `ulysses_attention`: an all-to-all swaps the T-sharding for an
  H-sharding, `flash_attention` runs the whole sequence on this rank's H/n
  heads (the hand-written kernels on the card), and the inverse all-to-all
  swaps back; the all-to-all's backward is the inverse all-to-all.

Each rank's kernel sees its local shapes, so nothing here divides a batch
by a mesh again (the JAX package's ops/mesh_dispatch.no_mesh)."""

from __future__ import annotations

import math

import torch

from ..ops.flash_ops import NEG_INF, flash_attention, scaled_dot_product_attention  # noqa: F401
from .collective import all_to_all, ppermute_ring
from .mesh import SP


def shard_sequence(x: torch.Tensor, mesh, axis: str = SP) -> torch.Tensor:
    """This rank's shard of a global [B, T, H, D] tensor along T."""
    if x.dim() != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(x.shape)}")
    n, i = mesh.size(axis), mesh.axis_index(axis)
    if x.shape[1] % n:
        raise ValueError(f"T={x.shape[1]} not divisible by {axis}={n}")
    t = x.shape[1] // n
    return x[:, i * t:(i + 1) * t]


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shards differ: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _scores(q, kb, scale, causal, i, src, tl):
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb.float()) * scale
    if causal and src == i:  # the diagonal block; blocks after it are skipped
        pos = torch.arange(tl, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, torch.full((), NEG_INF,
                                                                     device=q.device))
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal):
        n, i = mesh.size(axis), mesh.axis_index(axis)
        B, tl, H, D = q.shape
        scale = 1.0 / math.sqrt(D)
        qf = q.float()
        m = torch.full((B, H, tl), NEG_INF, device=q.device)
        l = torch.zeros((B, H, tl), device=q.device)
        o = torch.zeros((B, tl, H, D), device=q.device)
        kb, vb = k, v
        for step in range(n):
            src = (i - step) % n  # the block held arrived from rank i - step
            if not (causal and src > i):
                s = _scores(qf, kb, scale, causal, i, src, tl)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
                    "bhqk,bkhd->bqhd", p, vb.float())
                m = m_new
            if step < n - 1:
                kb = ppermute_ring(kb, axis, mesh=mesh)
                vb = ppermute_ring(vb, axis, mesh=mesh)
        l = torch.clamp(l, min=1e-30)
        out = o / l.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.args = (mesh, axis, causal)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal = ctx.args
        n, i = mesh.size(axis), mesh.axis_index(axis)
        B, tl, H, D = q.shape
        scale = 1.0 / math.sqrt(D)
        qf, do = q.float(), dout.float()
        dsum = (do * out).sum(-1).transpose(1, 2)  # [B, H, Tl]
        dq = torch.zeros_like(qf)
        kb, vb = k, v
        dk = torch.zeros((B, tl, H, D), device=q.device)
        dv = torch.zeros_like(dk)
        for step in range(n):
            src = (i - step) % n
            if not (causal and src > i):
                s = _scores(qf, kb, scale, causal, i, src, tl)
                p = torch.exp(s - lse[..., None])
                dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
                dp = torch.einsum("bqhd,bkhd->bhqk", do, vb.float())
                ds = p * (dp - dsum[..., None])
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
                dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            # each block's gradient travels with it; n hops bring it home
            dk = ppermute_ring(dk, axis, mesh=mesh)
            dv = ppermute_ring(dv, axis, mesh=mesh)
            if step < n - 1:
                kb = ppermute_ring(kb, axis, mesh=mesh)
                vb = ppermute_ring(vb, axis, mesh=mesh)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q, k, v, mesh, axis: str = SP, causal: bool = False):
    """Attention with the sequence axis sharded over `mesh`'s `axis`: q, k,
    v are this rank's [B, T/n, H, D] shards; the output is its shard of
    scaled_dot_product_attention over the whole sequence."""
    _check(q, k, v)
    return _Ring.apply(q, k, v, mesh, axis, causal)


def ulysses_attention(q, k, v, mesh, axis: str = SP, causal: bool = False):
    """All-to-all sequence parallelism (Ulysses): the head count must divide
    by the axis size; the same shard contract as ring_attention."""
    _check(q, k, v)
    n = mesh.size(axis)
    if q.shape[2] % n:
        raise ValueError(f"H={q.shape[2]} not divisible by {axis}={n}")
    group = mesh.group(axis)
    # [B, T/n, H, D] -> [B, T, H/n, D]
    q, k, v = (all_to_all(x, 2, 1, group, n) for x in (q, k, v))
    o = flash_attention(q, k, v, causal=causal)
    # [B, T, H/n, D] -> [B, T/n, H, D]
    return all_to_all(o, 1, 2, group, n)
