"""Elastic sharded checkpoints: background commit and resume with
resharding (paddle_tpu/pipeline/elastic.py).

1. **Background sharded commit.** A single-process sharded save has no
   barriers, so it rides the Trainer's writer thread
   (`submit_sharded_save`). The snapshot takes references to the scope's
   tensors (the ops replace tensors, they never write one in place), so
   the step loop pays for the references only; the device-to-host copy of
   each slice happens on the writer thread.
2. **Resume with resharding.** `sharded_meta.json` records each value's
   global shape and the slice each shard file holds, so the loader
   assembles whole host arrays whatever world wrote them; the restoring
   world's mesh executor then cuts its own slices on its next run
   (`reshard_scope_to_mesh` does it at once). A restore on another world
   is counted in `pt_ckpt_reshard_total`.

`gather_handoff_rows` and `restore_handoff_rows` are the serving sibling
(the state a prefill replica hands a decode replica crosses as host
rows): serving/disagg/handoff.py's, under the JAX package's names here.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import io
from ..core.executor import Scope, global_scope
from ..core.program import Program, default_main_program
from ..serving.disagg.handoff import gather_handoff_rows, restore_handoff_rows  # noqa: F401

logger = logging.getLogger("paddle_tpu_torch.pipeline")

RESHARD_COUNTER = "pt_ckpt_reshard_total"
_RESHARD_HELP = ("checkpoint restores whose saving world (device/process count) differed "
                 "from the restoring world")


def declare_reshard_counter() -> None:
    """The family exists at 0 before any elastic restore (declared by the
    PipelineExecutor's and Trainer's constructors and at import)."""
    from ..obs import metrics as obs

    obs.registry().declare_counter(RESHARD_COUNTER, _RESHARD_HELP)


def count_reshard() -> None:
    from ..obs import metrics as obs

    obs.registry().counter_inc(RESHARD_COUNTER, help=_RESHARD_HELP)


def snapshot_scope_refs(main_program: Optional[Program] = None,
                        scope: Optional[Scope] = None, copies: bool = False) -> Scope:
    """Reference-only snapshot of the scope's persistables (and the slices
    a mesh executor cut): safe to serialize from another thread while the
    step loop binds new tensors into the live scope. `copies=True` takes
    device copies instead, for buffers a later step writes in place (a
    captured window's)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    snap = Scope()
    for v in program.persistables():
        if scope.has(v.name):
            val = scope.get(v.name)
            snap.set(v.name, val.clone() if copies else val)
            if v.name in scope.shards:
                snap.shards[v.name] = scope.shards[v.name]
    return snap


def submit_sharded_save(writer, checkpoint_dir: str,
                        trainer_args: Optional[Dict[str, Any]] = None,
                        main_program: Optional[Program] = None,
                        scope: Optional[Scope] = None, max_num_checkpoints: int = 3,
                        reader=None, sharded: bool = True) -> None:
    """Hand a checkpoint commit to a `_CheckpointWriter`-style writer
    (submit/drain): the Trainer's every background save comes here,
    `sharded=False` for the gathered format. The snapshot is taken now, by
    reference; `reader` (a trainer `_HostReader`) copies it to the host on
    the writer thread, off the compute stream, after an event recorded
    now. Multi-process saves stay on the training thread: their barriers
    deadlock if one process commits from a side thread."""
    from ..parallel import distributed

    if distributed.process_count() > 1:
        raise NotImplementedError(
            "background sharded commit is single-process only: the multi-process save "
            "barriers must run on the thread every process is blocking on "
            "(CheckpointConfig(background=False) for multi-process sharded saves)")
    program = main_program or default_main_program()
    snap = snapshot_scope_refs(program, scope)
    after = None
    if reader is not None and reader.device.type == "cuda":
        after = torch.cuda.current_stream(reader.device).record_event()

    def commit():
        host = snap
        if reader is not None:
            host = Scope()
            names = list(snap.vars)
            for n, v in zip(names, reader.read([snap.get(n) for n in names], after)):
                host.set(n, v)
            host.shards.update(snap.shards)
        io.save_checkpoint(checkpoint_dir, trainer_args=trainer_args, main_program=program,
                           scope=host, max_num_checkpoints=max_num_checkpoints,
                           sharded=sharded)

    writer.submit(commit)


def current_world() -> Dict[str, int]:
    """The saving or restoring world: one device a process."""
    from ..parallel import distributed

    n = distributed.process_count()
    return {"device_count": int(n), "process_count": int(n)}


def reshard_scope_to_mesh(main_program: Optional[Program] = None,
                          scope: Optional[Scope] = None, mesh=None,
                          batch_axis: str = "dp", device=None) -> int:
    """Place restored host arrays for `mesh`: each value onto the rank's
    device, and a var whose `.sharding` names axes the mesh has cut to this
    rank's slice (axes the mesh lacks degrade to replicated, with one
    warning). The ZeRO slices are cut by the ParallelExecutor's next run
    from its own mesh, so the checkpoint stores global arrays, not
    placement. `device` defaults to this rank's (parallel/distributed.py).
    Returns the number of vars placed."""
    from ..parallel import distributed
    from ..parallel.mesh import local_slice, slice_owner

    if mesh is None:
        raise ValueError("reshard_scope_to_mesh needs a target mesh")
    program = main_program or default_main_program()
    scope = scope or global_scope()
    dev = torch.device(device) if device is not None else distributed.device()
    axis_names = set(mesh.axis_names)
    warned = False
    n = 0
    for v in program.persistables():
        if not scope.has(v.name):
            continue
        val = scope.get(v.name)
        if v.name in scope.shards:  # already a slice: leave it
            continue
        t = torch.as_tensor(np.asarray(val)) if isinstance(val, np.ndarray) else val
        spec = v.sharding
        if spec is not None:
            used = {a for a in spec if a is not None}
            if not used <= axis_names:
                if not warned:
                    warned = True
                    logger.warning("reshard: dropping sharding axes %s absent from the target "
                                   "mesh %s (vars fall back to replicated)",
                                   sorted(used - axis_names), sorted(axis_names))
                spec = None
        if spec is not None and any(mesh.size(a) > 1 for a in spec if a is not None):
            sl = local_slice(mesh, spec, tuple(t.shape))
            scope.shards[v.name] = {"shape": list(t.shape), "slice": sl,
                                    "owner": slice_owner(mesh, spec)}
            t = t[tuple(slice(a, b) for a, b in sl)]
        scope.set(v.name, t.to(dev).clone())
        n += 1
    return n


def load_checkpoint_resharded(checkpoint_dir: str, main_program: Optional[Program] = None,
                              scope: Optional[Scope] = None, mesh=None, device=None
                              ) -> Dict[str, Any]:
    """io.load_checkpoint (newest valid serial, quarantine, torn shards)
    then the placement for a (possibly different) mesh."""
    args = io.load_checkpoint(checkpoint_dir, main_program, scope, device=device)
    if mesh is not None:
        reshard_scope_to_mesh(main_program, scope, mesh, device=device)
    return args


declare_reshard_counter()
