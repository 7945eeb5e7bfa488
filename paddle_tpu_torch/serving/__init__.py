"""Serving (paddle_tpu/serving): a batching inference server and continuous
batching for generation models, on the card by default.

Layers, bottom-up:

- `engine`    ServingEngine: pads requests into batch (and opt-in
              sequence) buckets, so traffic runs a bounded set of shapes,
              with hit/miss, dispatch and sync accounting.
- `batcher`   MicroBatcher: coalesces concurrent requests into one padded
              batch (max_batch_size, max_wait_ms), with a bounded queue,
              deadlines and load shedding (AdmissionQueue, tiered by SLO
              class).
- `scheduler` ContinuousScheduler: token-level continuous batching over a
              pool of decode slots on the device; the pool step is one CUDA
              graph replayed a token on the card; early exit, streamed
              token events, an fp or int8 prefix cache.
- `prefix_cache` PrefixCache: the byte-budgeted LRU of prefix states.
- `server`    ModelRegistry and the threaded stdlib-HTTP front end
              (/predict, /generate with NDJSON streaming, /healthz, /stats,
              /metrics).
- `metrics`   MetricSet: the namespaced view over the process-wide registry
              (obs/metrics.py) that /metrics renders.
- `router`    the scale-out front end: join-shortest-queue routing over N
              replica processes with per-replica breakers, health probes,
              retry and failover, streaming pass-through, warm standbys
              (WarmPool) and the supervised Fleet.
- `disagg`    disaggregated serving: prefill and decode replica classes,
              the PTHO1 handoff payload and the dispatcher between them.

CLI: `python -m paddle_tpu_torch serve --model_dir <artifact>` (with
`--replicas N` a router over a replica fleet, with `--disaggregate` the
phase-split fleet); `python -m paddle_tpu_torch route --replica URL ...`
fronts replicas already running.
"""

from ..resilience.breaker import CircuitBreaker, CircuitOpenError  # noqa: F401
from .batcher import AdmissionQueue, DeadlineError, MicroBatcher, ShedError  # noqa: F401
from .engine import BucketPolicy, ServingEngine  # noqa: F401
from .metrics import Histogram, MetricSet  # noqa: F401
from .prefix_cache import PrefixCache, prefix_row_key  # noqa: F401
from .scheduler import ContinuousScheduler, GenerationAborted, GenHandle  # noqa: F401
from .server import REQUEST_ID_HEADER, ModelRegistry, ServingServer, make_server  # noqa: F401
from .router import (Fleet, NoReplicaError, ReplicaProcess, Router, RouterServer,  # noqa: F401
                     WarmPool, make_router_server, replica_spawner)

__all__ = [
    "Fleet",
    "NoReplicaError",
    "ReplicaProcess",
    "Router",
    "RouterServer",
    "WarmPool",
    "make_router_server",
    "replica_spawner",
    "REQUEST_ID_HEADER",
    "BucketPolicy",
    "ServingEngine",
    "MicroBatcher",
    "AdmissionQueue",
    "ShedError",
    "DeadlineError",
    "CircuitBreaker",
    "CircuitOpenError",
    "ContinuousScheduler",
    "GenHandle",
    "GenerationAborted",
    "PrefixCache",
    "prefix_row_key",
    "MetricSet",
    "Histogram",
    "ModelRegistry",
    "ServingServer",
    "make_server",
]
