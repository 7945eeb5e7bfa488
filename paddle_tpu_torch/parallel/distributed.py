"""Multi-process membership and initialization
(paddle_tpu/parallel/distributed.py).

The JAX package joins `jax.distributed`'s coordinator. Here the same
environment joins a `torch.distributed` process group: COORDINATOR_ADDRESS
(`host:port` for a TCP rendezvous, or a `file://` path), NUM_PROCESSES and
PROCESS_ID, read as the JAX package reads them. The backend follows the
device: NCCL when the process runs on a card, gloo on the CPU. Each rank's
card is `cuda:{local rank}`: LOCAL_RANK when set, else the process id
modulo the node's cards. Membership is static for a job; checkpoints
cover recovery (trainer.py, pipeline/elastic.py)."""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

logger = logging.getLogger("paddle_tpu_torch.distributed")

_initialized = False
_device: Optional[torch.device] = None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, backend: Optional[str] = None) -> None:
    """Join the job's process group. Without a coordinator the run is
    single-process, LOUDLY: a misconfigured cluster job training on one
    host is what the reference's etcd desired-count barrier existed to
    prevent (go/pserver/etcd_client.go:31-41), so the warning names the
    missing variables. `device="cpu"` takes gloo; otherwise the card and
    NCCL. `backend="gloo"` on the card runs gloo's collectives on CUDA
    tensors (ranks sharing one card, where NCCL refuses two ranks)."""
    global _initialized, _device
    if _initialized:
        return
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = int(num_processes or os.environ.get("NUM_PROCESSES", 1))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(
                f"init_distributed: num_processes={num_processes} (arg or NUM_PROCESSES "
                "env) but no coordinator_address — set COORDINATOR_ADDRESS")
        logger.warning(
            "init_distributed: no COORDINATOR_ADDRESS — running SINGLE-HOST. For "
            "multi-host, set COORDINATOR_ADDRESS=<host:port>, NUM_PROCESSES and "
            "PROCESS_ID on every process.")
        _device = torch.device("cpu") if on_cpu else None
        _initialized = True
        return
    process_id = int(process_id if process_id is not None
                     else os.environ.get("PROCESS_ID", 0))
    if on_cpu:
        _device, backend = torch.device("cpu"), backend or "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device=\"cpu\" for a "
                               "gloo group on the CPU")
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        _device, backend = torch.device("cuda", local), backend or "nccl"
        torch.cuda.set_device(_device)
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    logger.info("init_distributed: joining %s as process %d/%d over %s", init, process_id,
                num_processes, backend)
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    _initialized = True


def shutdown() -> None:
    """Leave the process group (the counterpart of init_distributed)."""
    global _initialized, _device
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _device = False, None


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _group_up() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _group_up() else 0


def is_chief() -> bool:
    """The reference elected a model-saving trainer (go/master/service.go:481
    RequestSaveModel); here process 0 is the chief."""
    return process_index() == 0


def device() -> torch.device:
    """This rank's device: what init_distributed chose, else the card
    (core/place.py's default, which raises where there is none), whatever
    backend a group set up elsewhere uses: the CPU is named, never
    inferred."""
    if _device is not None:
        return _device
    from ..core.place import resolve_device

    return resolve_device(None)


def _comm_device() -> torch.device:
    """Where a group's small host-side values travel: NCCL takes CUDA
    tensors only; gloo takes the CPU's."""
    import torch.distributed as dist

    return device() if dist.get_backend() == "nccl" else torch.device("cpu")


def broadcast_int(value: int) -> int:
    """The chief's `value`, on every process (the group must be up)."""
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, 0)
    return int(t.item())


def barrier() -> None:
    """Every process of the group waits for the others."""
    import torch.distributed as dist

    dev = _comm_device()
    dist.barrier(**({"device_ids": [dev.index]} if dev.type == "cuda" else {}))
