"""paddle_tpu_torch.pipeline: micro-batch pipeline parallelism and elastic
sharded checkpoints (paddle_tpu/pipeline/__init__.py).

- partition: split a training Program's forward block into K stages at
  `stage_boundary()` markers or at automatic cost-balanced cuts.
- schedule: `PipelineExecutor` runs the K-stage, M-micro-batch GPipe grid
  (or its 1F1B-memory variant) as eager stage runs, the backward drain by
  stage.
- elastic: background sharded checkpoint commits on the Trainer's writer
  thread, and resume with resharding onto another world.

    exe = pipeline.PipelineExecutor(num_stages=2, num_microbatches=8)
    exe.run(main_program, feed={...}, fetch_list=[loss])
"""

from .elastic import (  # noqa: F401
    current_world,
    declare_reshard_counter,
    gather_handoff_rows,
    load_checkpoint_resharded,
    reshard_scope_to_mesh,
    restore_handoff_rows,
    snapshot_scope_refs,
    submit_sharded_save,
)
from .partition import Stage, StagedProgram, split_program, stage_boundary  # noqa: F401
from .schedule import PipelineExecutor  # noqa: F401

__all__ = [
    "PipelineExecutor",
    "Stage",
    "StagedProgram",
    "split_program",
    "stage_boundary",
    "declare_reshard_counter",
    "load_checkpoint_resharded",
    "reshard_scope_to_mesh",
    "snapshot_scope_refs",
    "submit_sharded_save",
]
