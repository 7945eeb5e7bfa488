"""Parallelism and communication (paddle_tpu/parallel/__init__.py).

The reference's distribution stack (MultiGradientMachine's ring
all-reduce, the C++/Go parameter servers, DistributeTranspiler, the NCCL
ops, gRPC send/recv, etcd membership) becomes `torch.distributed` process
groups over a Mesh's rank axes (dp, mp, sp) and a pipeline's devices (pp):
data_parallel.py has the mapping. ring_attention.py is sequence
parallelism over `sp`; pipeline/ the stages.
"""

from ..ops.flash_ops import flash_attention  # noqa: F401
from .collective import (  # noqa: F401
    all_gather,
    all_reduce,
    broadcast,
    ppermute_ring,
    reduce_scatter,
    ring_all_reduce,
    shard_map_fn,
)
from .data_parallel import ParallelExecutor  # noqa: F401
from .distributed import init_distributed, is_chief, process_count, process_index  # noqa: F401
from .mesh import (  # noqa: F401
    DP,
    MP,
    PP,
    SP,
    Mesh,
    batch_sharded,
    dim_sharded,
    make_mesh,
    mesh_from_spec,
    parse_mesh_spec,
    replicated,
)
from .ring_attention import (  # noqa: F401
    ring_attention,
    scaled_dot_product_attention,
    shard_sequence,
    ulysses_attention,
)
from .sharded_embedding import sharded_embedding  # noqa: F401
