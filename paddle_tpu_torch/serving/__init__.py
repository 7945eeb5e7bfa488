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

The router, disaggregated serving and the fleet wait for ROADMAP.md A8c,
speculative decoding for A8b, and the `serve` command for A12.
"""

from ..resilience.breaker import CircuitBreaker, CircuitOpenError  # noqa: F401
from .batcher import AdmissionQueue, DeadlineError, MicroBatcher, ShedError  # noqa: F401
from .engine import BucketPolicy, ServingEngine  # noqa: F401
from .metrics import Histogram, MetricSet  # noqa: F401
from .prefix_cache import PrefixCache, prefix_row_key  # noqa: F401
from .scheduler import ContinuousScheduler, GenerationAborted, GenHandle  # noqa: F401
from .server import REQUEST_ID_HEADER, ModelRegistry, ServingServer, make_server  # noqa: F401

__all__ = [
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
