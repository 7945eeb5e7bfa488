"""Row-wise (SelectedRows) gradients of `is_sparse` embedding tables
(paddle_tpu/core/sparse.py `SelectedRows`, `SparseGradTape`), the
reference's framework/selected_rows.h.

A parameter marked `sparse_update` never gets a dense [vocab, dim]
gradient. Each `lookup_table` site that reads it gathers the rows from the
detached table into a leaf that requires grad and records the site on the
run's tape; at the `autodiff` op the leaves' gradients are the values and
the recorded ids the rows. The optimizer ops then update only those rows
(ops/optimizer_ops.py). A regularizer or a clip would make the gradient
dense, so such a parameter skips both, as in the JAX package
(optimizer/__init__.py `minimize`). The sparse feed slots (`SparseArray`)
are not ported.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


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
