"""Serving metrics: a namespaced view over the process-wide registry
(paddle_tpu/serving/metrics.py).

The storage and the Prometheus renderer live in `obs.metrics`: one
registry shared with the trainer's counters, the fault registry, the trace
session and the global StatSet. A `MetricSet` prepends its namespace
(`ptserving_` by default) to every family it registers, and `render()`
returns the whole exposition, so `/metrics` scrapes the training-side
families too. Host-side and thread-safe; no torch in this module.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from ..obs import metrics as _obs_metrics
from ..obs.metrics import DEFAULT_LATENCY_BUCKETS, Histogram, _sanitize  # noqa: F401

__all__ = ["Histogram", "MetricSet", "DEFAULT_LATENCY_BUCKETS", "FIRST_TOKEN_BUCKETS",
           "TOKEN_INTERVAL_BUCKETS"]

# generation-serving latency grids (continuous batching): the first token
# is queue wait + prefix run + one pool step (ms to seconds); the
# inter-token interval is about one pool step (sub-ms to tens of ms)
FIRST_TOKEN_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)
TOKEN_INTERVAL_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0,
)


class MetricSet:
    """Namespaced registration view over the process-wide MetricsRegistry
    (obs.metrics.registry()).

    Gauges are callables evaluated at scrape time (queue depth, slot
    occupancy): the instrumented component owns the value. `stat_set`: the
    global StatSet already rides the unified render as `pt_timer_*`; a
    private StatSet passed here is attached under this view's namespace."""

    def __init__(self, namespace: str = "ptserving", stat_set=None,
                 registry: Optional[_obs_metrics.MetricsRegistry] = None):
        self.namespace = namespace
        self.registry = registry if registry is not None else _obs_metrics.registry()
        self.stat_set = stat_set
        if stat_set is not None and not _is_global_stat_set(stat_set):
            self.registry.attach_stat_set(stat_set, prefix=f"{namespace}_timer_")

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}"

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  help: str = "") -> Histogram:
        return self.registry.histogram(self._full(name), buckets, help)

    def declare_counter(self, name: str, help: str = "",
                        labels: Optional[Dict[str, Any]] = None) -> None:
        """Pre-register the series at 0, so a scraper never sees the family
        appear mid-flight."""
        self.registry.declare_counter(self._full(name), help, labels)

    def counter_inc(self, name: str, by: float = 1.0, help: str = "",
                    labels: Optional[Dict[str, Any]] = None) -> None:
        self.registry.counter_inc(self._full(name), by, help, labels)

    def counter_value(self, name: str, labels: Optional[Dict[str, Any]] = None) -> float:
        return self.registry.counter_value(self._full(name), labels)

    def gauge(self, name: str, fn: Callable[[], float], help: str = "") -> None:
        self.registry.gauge(self._full(name), fn, help)

    def render(self) -> str:
        """The unified exposition: every family of the process-wide
        registry, not only this namespace's."""
        return self.registry.render()


def _is_global_stat_set(stat_set) -> bool:
    from .. import profiler

    return stat_set is profiler.global_stat_set()
