"""Sparse feed slots (`SparseArray`) and row-wise (SelectedRows) gradients
of `is_sparse` embedding tables (paddle_tpu/core/sparse.py), the
reference's CpuSparseMatrix input slots and framework/selected_rows.h.

A sparse batch is padded COO, as in the JAX package: `indices` [cap]
int32 (padding 0), `values` [cap] (1.0 for a binary slot, padding 0) and
`rowids` [cap] int32 (padding `batch`), with the static `batch` and `dim`.
`from_batch` lays the nonzeros out row by row, so `rowids` is sorted; the
product with a dense weight is then a gather and a sum over each row's
contiguous run (`torch.segment_reduce`), never an [N, dim] tensor. Neither
that sum nor its backward, nor the gather's (`F.embedding`, which sorts
its indices), adds with atomics: a step's bits do not change from run to
run.

A parameter marked `sparse_update` never gets a dense [vocab, dim]
gradient. Each `lookup_table` site that reads it gathers the rows from the
detached table into a leaf that requires grad and records the site on the
run's tape; at the `autodiff` op the leaves' gradients are the values and
the recorded ids the rows. The optimizer ops then update only those rows
(ops/optimizer_ops.py). A regularizer or a clip would make the gradient
dense, so such a parameter skips both, as in the JAX package
(optimizer/__init__.py `minimize`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .lod import LoDArray, _round_up


class SparseArray:
    """A batch of sparse feature vectors in padded COO (the module
    docstring): the value of a `data(..., sparse_format=...)` slot."""

    def __init__(self, indices, values, rowids, batch: int, dim: int):
        self.indices = indices
        self.values = values
        self.rowids = rowids
        self.batch = int(batch)
        self.dim = int(dim)

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[-1])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @staticmethod
    def from_batch(samples: Sequence, dim: int, format: str = "binary",
                   capacity: Optional[int] = None, bucket: int = 128, dtype=np.float32,
                   device="cpu") -> "SparseArray":
        """From each sample's nonzeros: its active column indices
        (format="binary") or its (index, value) pairs ("float"). The
        capacity is `capacity`, else the nonzeros rounded up to `bucket`."""
        n = len(samples)
        if format == "binary":
            cols = [np.asarray(s, np.int64).reshape(-1) for s in samples]
            vals = [np.ones(len(c)) for c in cols]
        elif format == "float":
            pairs = [np.asarray(s, np.float64).reshape(-1, 2) for s in samples]
            cols = [p[:, 0].astype(np.int64) for p in pairs]
            vals = [p[:, 1] for p in pairs]
        else:
            raise ValueError(f"unknown sparse format {format!r}")
        counts = [len(c) for c in cols]
        nnz = sum(counts)
        cap = capacity or max(_round_up(max(nnz, 1), bucket), bucket)
        if nnz > cap:
            raise ValueError(f"batch nonzeros {nnz} exceed capacity {cap}")
        flat = np.concatenate(cols) if cols else np.zeros((0,), np.int64)
        bad = flat[(flat < 0) | (flat >= dim)]
        if bad.size:
            raise ValueError(f"sparse index {int(bad[0])} out of range [0, {dim})")
        idx = np.zeros((cap,), np.int32)
        val = np.zeros((cap,), dtype)
        row = np.full((cap,), n, np.int32)  # padding: past the last row
        idx[:nnz] = flat
        if nnz:
            val[:nnz] = np.concatenate(vals)
        row[:nnz] = np.repeat(np.arange(n, dtype=np.int32), counts)
        return SparseArray(*(torch.as_tensor(a, device=device) for a in (idx, val, row)),
                           batch=n, dim=dim)

    def leaves(self) -> tuple:
        """(indices, values, rowids): the tensors a feed signature, a copy,
        a stack or a graph's buffers take; `with_leaves` builds it again."""
        return (self.indices, self.values, self.rowids)

    def with_leaves(self, leaves) -> "SparseArray":
        return SparseArray(*leaves, batch=self.batch, dim=self.dim)

    def to(self, device) -> "SparseArray":
        return self.with_leaves([t.to(device) for t in self.leaves()])

    def matmul(self, w):
        """self @ w for a dense w [dim, out]: each nonzero's row of w times
        its value, summed over the rows' runs of `rowids` (padding falls
        past the last run and is dropped)."""
        contrib = F.embedding(self.indices, w) * self.values[:, None].to(w.dtype)
        starts = torch.arange(self.batch + 1, dtype=self.rowids.dtype, device=self.device)
        offsets = torch.searchsorted(self.rowids, starts)
        return torch.segment_reduce(contrib, "sum", offsets=offsets, axis=0, unsafe=True)

    def to_dense(self):
        """[batch, dim] (tests and small dims only)."""
        out = torch.zeros((self.batch + 1, self.dim), dtype=self.dtype, device=self.device)
        out.index_put_((self.rowids.long(), self.indices.long()), self.values,
                       accumulate=True)
        return out[:-1]

    def __repr__(self):
        return f"SparseArray(batch={self.batch}, dim={self.dim}, capacity={self.capacity})"


def feed_leaves(v) -> tuple:
    """A feed value's tensors: a LoDArray's or a SparseArray's leaves, else
    the value itself."""
    return v.leaves() if isinstance(v, (LoDArray, SparseArray)) else (v,)


def feed_like(v, leaves):
    """The feed value of `v`'s kind on `leaves` (feed_leaves' inverse)."""
    if isinstance(v, SparseArray):
        return v.with_leaves(leaves)
    return LoDArray(*leaves) if isinstance(v, LoDArray) else leaves[0]


class SelectedRows:
    """(rows, values) of a [num_rows, D] tensor: `rows` [k] int64 may
    repeat (one entry a lookup occurrence) and a row equal to num_rows is
    padding, dropped; the dense value is zeros.index_add(rows, values)."""

    def __init__(self, rows, values, num_rows: int):
        self.rows = rows
        self.values = values
        self.num_rows = int(num_rows)

    def to_dense(self):
        out = torch.zeros((self.num_rows + 1,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_add(0, self.rows, self.values)[:-1]

    def dedup(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(unique rows, their summed values), padding dropped: the
        dense-equivalent gradient of the touched rows, which an update
        nonlinear in the gradient (Adam) needs."""
        uniq, inv = torch.unique(self.rows, return_inverse=True)
        summed = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                             dtype=self.values.dtype, device=self.values.device)
        summed = summed.index_add(0, inv, self.values)
        keep = uniq < self.num_rows
        return uniq[keep], summed[keep]


class SparseGradTape:
    """The lookup sites of the sparse parameters in one training run:
    (parameter, rows, the gathered leaf, the table's rows) in the order
    the forward ran."""

    def __init__(self, params):
        self.params = set(params)
        self.sites: List[Tuple[str, torch.Tensor, torch.Tensor, int]] = []

    def gather(self, name: str, w, rows):
        """w[rows] as a leaf whose gradient is the site's values; `rows`
        (padding pointed at num_rows) recorded beside it."""
        leaf = w.detach()[rows.clamp(max=w.shape[0] - 1)].requires_grad_(True)
        self.sites.append((name, rows, leaf, int(w.shape[0])))
        return leaf

    def leaves(self) -> list:
        return [leaf for _, _, leaf, _ in self.sites]

    def gradients(self, grads) -> dict:
        """{parameter: SelectedRows} from the leaves' gradients (None where a
        site's output reached no loss), `grads` aligned with `sites`."""
        missing = self.params - {name for name, _, _, _ in self.sites}
        if missing:
            raise ValueError(f"sparse_update parameters {sorted(missing)} have no "
                             "lookup_table site in the program: only embedding gathers "
                             "take SelectedRows gradients")
        out = {}
        for p in sorted(self.params):
            at = [(rows, torch.zeros_like(leaf) if g is None else g, n)
                  for (name, rows, leaf, n), g in zip(self.sites, grads) if name == p]
            dim = at[0][1].shape[-1]
            out[p] = SelectedRows(torch.cat([r.reshape(-1) for r, _, _ in at]),
                                  torch.cat([g.reshape(-1, dim) for _, g, _ in at]),
                                  num_rows=at[0][2])
        return out
