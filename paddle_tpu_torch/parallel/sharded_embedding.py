"""Vocab-sharded embedding tables (paddle_tpu/parallel/sharded_embedding.py).

The reference keeps huge tables off the trainers: sparse-row parameters
live on pservers, trainers prefetch the rows a batch needs and push sparse
gradients back (math/SparseRowMatrix.h:31,206,237;
trainer/RemoteParameterUpdater.h:265). The JAX package stripes the rows
over the `mp` axis and lets XLA shard the gather. Here the table's
`.sharding` stripes its rows over the `mp` ranks, and
parallel.ParallelExecutor runs its `lookup_table` so: each rank looks up
the ids that fall in its rows (zeros elsewhere) and an all-reduce sums the
pieces, whose backward hands each rank the whole output gradient. So the
gradient lands only on the rows a rank owns, and each id's row comes from
one rank exactly (the sum adds zeros): the plain lookup's values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..initializer import NormalInitializer
from ..layers.helper import LayerHelper
from .mesh import MP


def sharded_embedding(input, size, mesh_axis: str = MP, padding_idx: Optional[int] = None,
                      param_attr=None, dtype=np.float32, name=None):
    """Like layers.embedding, but the table is sharded over `mesh_axis`.
    Run it with a ParallelExecutor whose mesh has that axis."""
    helper = LayerHelper("sharded_embedding", name=name)
    w = helper.create_parameter(param_attr, shape=tuple(size), dtype=dtype,
                                default_initializer=NormalInitializer(0.0, 0.01))
    w.sharding = (mesh_axis, None)  # rows striped across ranks
    out = helper.create_tmp_variable(dtype, tuple(input.shape) + (size[1],), input.lod_level)
    helper.append_op(type="lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": True, "padding_idx": padding_idx})
    return out
