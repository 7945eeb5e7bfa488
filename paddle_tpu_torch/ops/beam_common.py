"""Shared beam-search machinery (paddle_tpu/ops/beam_common.py): the
expand / prune / backtrack cycle on torch tensors."""

from __future__ import annotations

import torch

NEG_INF = -1e9


def init_scores(B: int, K: int, dtype=torch.float32, device="cpu"):
    """[B, K] scores with only beam 0 live at t=0, so the first expansion
    isn't K duplicates of the same hypothesis."""
    row = torch.full((K,), NEG_INF, dtype=torch.float32, device=device)
    row[:1].fill_(0.0)  # a fill, not a copy from the host: legal under graph capture
    return row.expand(B, K).to(dtype)


def freeze_finished(logp, finished, eos: int):
    """Finished hypotheses may only emit EOS, at zero cost; every other
    continuation is NEG_INF."""
    V = logp.shape[-1]
    eos_only = torch.full((V,), NEG_INF, dtype=logp.dtype, device=logp.device)
    eos_only[eos:eos + 1].fill_(0.0)  # a fill, not a copy from the host
    return torch.where(finished[..., None], eos_only, logp)


def topk_lowest_index(x, K: int):
    """Top-K along the last axis, best first, ties to the lower index —
    the order `jax.lax.top_k` promises and `torch.topk` does not.

    The K-th value v is exact whatever topk's tie order. The selection is
    every element above v (fewer than K) and then the lowest-index elements
    equal to v: an int32 key that ranks the first group above the second,
    and within each group the lower index higher, picks them with one more
    topk."""
    N = x.shape[-1]
    if 2 * N >= 2 ** 31:
        raise ValueError(f"topk_lowest_index: row of {N} elements is too long")
    v = torch.topk(x, K, dim=-1).values[..., -1:]
    ar = torch.arange(N, dtype=torch.int32, device=x.device)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    key = torch.where(x > v, 2 * N - ar, torch.where(x == v, N - ar, zero))
    top = torch.topk(key, K, dim=-1).values
    idx = torch.where(top > N, 2 * N - top, N - top).long()
    vals = torch.gather(x, -1, idx)
    # idx ascends within each group and the groups hold different values,
    # so a stable sort by value gives (value desc, index asc)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def expand_prune(scores, logp, K: int):
    """Add per-token log-probs, take the global top-K over [K*V].
    Returns (new_scores [B,K], parent [B,K], token [B,K] int32)."""
    B = scores.shape[0]
    V = logp.shape[-1]
    total = scores[..., None] + logp
    top_sc, top_idx = topk_lowest_index(total.reshape(B, K * V), K)
    return top_sc, top_idx // V, (top_idx % V).to(torch.int32)


def backtrack(parents, toks, B: int, K: int):
    """Walk the (parent, token) trellis backwards → ids [B, K, T]."""
    T = len(toks)
    beam = torch.arange(K, device=toks[0].device).expand(B, K)
    ids = []
    for t in range(T - 1, -1, -1):
        ids.append(torch.gather(toks[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam)
    return torch.stack(ids[::-1], dim=-1)


def finalize(ids, scores, eos: int, T: int, length_normalize: bool):
    """Lengths to first EOS (inclusive), optional length-normalized re-sort
    best-first. Returns (ids, scores, lengths)."""
    is_eos = ids == eos
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)  # first max
    lengths = torch.where(is_eos.any(-1), first_eos + 1, T).to(torch.int32)
    if length_normalize:
        scores = scores / lengths.clamp(min=1).to(scores.dtype)
        order = torch.argsort(-scores, dim=1, stable=True)
        scores = torch.gather(scores, 1, order)
        ids = torch.gather(ids, 1, order[..., None].expand_as(ids))
        lengths = torch.gather(lengths, 1, order)
    return ids, scores, lengths
