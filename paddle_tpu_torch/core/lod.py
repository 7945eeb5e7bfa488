"""Ragged (variable-length) batch in padded-flat form — the LoD equivalent.

The layout of paddle_tpu/core/lod.py, on torch tensors:

  data     : [capacity, ...]   all tokens of all sequences concatenated,
                               then padded up to `capacity`
  seq_ids  : [capacity] int32  segment id per token; padding slots = -1
  lengths  : [max_seqs] int32  per-sequence token counts (0 for absent seqs)
  num_seqs : 0-d int32         actual number of sequences in the batch

Keeping the same layout means a feed or a fetch compares one to one with
the JAX package's. Recurrences convert to time-major dense + mask with
`to_batch()` and back with `from_batch()`.

A second level (the sub-sequences of a hierarchical RNN's input) is
carried as `sub_seq_ids` [capacity] int32, the sub-sequence of each token
numbered across the batch, -1 on padding (`from_nested_sequences`); it is
None on a 1-level batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class LoDArray:
    """Ragged batch of sequences in padded-flat form (see module docstring)."""

    def __init__(self, data, seq_ids, lengths, num_seqs, sub_seq_ids=None):
        self.data = data
        self.seq_ids = seq_ids
        self.lengths = lengths
        self.num_seqs = num_seqs
        self.sub_seq_ids = sub_seq_ids

    @staticmethod
    def from_sequences(
        seqs: Sequence[np.ndarray],
        capacity: Optional[int] = None,
        max_seqs: Optional[int] = None,
        bucket: int = 128,
        dtype=None,
        device="cpu",
    ) -> "LoDArray":
        """Build from a list of [len_i, ...] numpy arrays on `device`."""
        seqs = [np.asarray(s) for s in seqs]
        total = sum(int(s.shape[0]) for s in seqs)
        cap = capacity or max(_round_up(max(total, 1), bucket), bucket)
        if total > cap:
            raise ValueError(f"total tokens {total} exceed capacity {cap}")
        nseq_cap = max_seqs or len(seqs)
        if len(seqs) > nseq_cap:
            raise ValueError(f"{len(seqs)} sequences exceed max_seqs {nseq_cap}")
        trailing = seqs[0].shape[1:] if seqs else ()
        dt = dtype or (seqs[0].dtype if seqs else np.float32)
        data = np.zeros((cap,) + tuple(trailing), dtype=dt)
        seq_ids = np.full((cap,), -1, dtype=np.int32)
        lengths = np.zeros((nseq_cap,), dtype=np.int32)
        off = 0
        for i, s in enumerate(seqs):
            n = int(s.shape[0])
            data[off : off + n] = s
            seq_ids[off : off + n] = i
            lengths[i] = n
            off += n
        return LoDArray(
            torch.as_tensor(data, device=device),
            torch.as_tensor(seq_ids, device=device),
            torch.as_tensor(lengths, device=device),
            torch.tensor(len(seqs), dtype=torch.int32, device=device),
        )

    @staticmethod
    def from_nested_sequences(
        nested: Sequence[Sequence[np.ndarray]],
        capacity: Optional[int] = None,
        max_seqs: Optional[int] = None,
        bucket: int = 128,
        dtype=None,
        device="cpu",
    ) -> "LoDArray":
        """A 2-level batch: `nested` a list of sequences, each a list of
        [len, ...] sub-sequence arrays; `sub_seq_ids` numbers the
        sub-sequences across the batch (paddle_tpu/core/lod.py:98)."""
        base = LoDArray.from_sequences(
            [np.concatenate(s, axis=0) for s in nested], capacity=capacity,
            max_seqs=max_seqs, bucket=bucket, dtype=dtype, device=device)
        sub_ids = np.full((base.capacity,), -1, dtype=np.int32)
        off = g = 0
        for s in nested:
            for ss in s:
                n = int(np.asarray(ss).shape[0])
                sub_ids[off:off + n] = g
                off += n
                g += 1
        return LoDArray(base.data, base.seq_ids, base.lengths, base.num_seqs,
                        torch.as_tensor(sub_ids, device=device))

    def to(self, device) -> "LoDArray":
        return LoDArray(*(t.to(device) for t in self.leaves()))

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def max_seqs(self) -> int:
        return self.lengths.shape[0]

    @property
    def token_mask(self):
        """[capacity] bool — True on real tokens."""
        return self.seq_ids >= 0

    @property
    def offsets(self):
        """[max_seqs + 1] int32 exclusive scan of lengths."""
        zero = torch.zeros(1, dtype=torch.int32, device=self.lengths.device)
        return torch.cat([zero, torch.cumsum(self.lengths, 0, dtype=torch.int32)])

    def to_batch(self, max_len: Optional[int] = None, time_major: bool = True):
        """Ragged-flat → dense [T, B, ...] (+ bool mask [T, B]); with
        time_major=False, [B, T, ...] and [B, T]. Sequences are left
        aligned; tokens past `max_len` are dropped."""
        if max_len is None:
            max_len = self.capacity
        offs = self.offsets[:-1].long()
        t_idx = torch.arange(max_len, device=self.device)[None, :]
        gather = (offs[:, None] + t_idx).clamp(0, self.capacity - 1)
        valid = t_idx < self.lengths[:, None]
        batched = torch.where(
            valid.reshape(valid.shape + (1,) * (self.data.dim() - 1)),
            self.data[gather],
            torch.zeros((), dtype=self.data.dtype, device=self.device),
        )
        if time_major:
            return batched.transpose(0, 1).contiguous(), valid.T.contiguous()
        return batched, valid

    @staticmethod
    def from_batch(batched, mask, like: "LoDArray") -> "LoDArray":
        """Inverse of to_batch: dense [T, B, ...] + mask → ragged-flat, with
        the same lod structure as `like`."""
        if batched.shape[0] != mask.shape[0]:
            raise ValueError("batched/mask disagree")
        T, B = mask.shape
        batched_bm = batched.transpose(0, 1)
        offs = like.offsets[:-1].long()
        flat_idx = offs[:, None] + torch.arange(T, device=batched.device)[None, :]
        flat_idx = torch.where(mask.T, flat_idx, like.capacity)  # dump padding
        data = torch.zeros((like.capacity + 1,) + tuple(batched.shape[2:]),
                           dtype=batched.dtype, device=batched.device)
        data[flat_idx.reshape(-1)] = batched_bm.reshape((B * T,) + tuple(batched.shape[2:]))
        return LoDArray(data[:-1], like.seq_ids, like.lengths, like.num_seqs,
                        like.sub_seq_ids)

    def leaves(self) -> tuple:
        """(data, seq_ids, lengths, num_seqs[, sub_seq_ids]): the tensors a
        feed signature, a copy, a stack or a graph's buffers take one by
        one; `LoDArray(*leaves)` builds it again."""
        base = (self.data, self.seq_ids, self.lengths, self.num_seqs)
        return base if self.sub_seq_ids is None else base + (self.sub_seq_ids,)

    def with_data(self, data) -> "LoDArray":
        return LoDArray(data, self.seq_ids, self.lengths, self.num_seqs, self.sub_seq_ids)

    def __repr__(self):
        return f"LoDArray(data={tuple(self.data.shape)}, max_seqs={self.max_seqs})"
