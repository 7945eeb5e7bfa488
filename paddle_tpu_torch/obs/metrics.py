"""One process-wide metrics registry behind one Prometheus renderer
(paddle_tpu/obs/metrics.py:77-449, the same families and the same text).

- histograms, counters and gauges live in ONE process-wide store
  (`registry()`): the trainer's dispatch/sync/checkpoint/guard counters
  are gauges read at render time;
- external accounting joins at render time through collectors: the global
  `profiler.StatSet` timers, the fault registry's per-point hit/fire
  counts, the active trace capture's dropped-event counter;
- the renderer is Prometheus-text-format compliant: `# HELP`/`# TYPE`
  exactly once per family, label values escaped.

The JAX package's tune and quant collectors wait for the port's autotuner
and quant exporter (ROADMAP.md, queue A, A11 and A9b). Thread-safe
throughout; no torch in this module.
"""

from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "registry",
]

# seconds; spans sub-ms CPU fc models to multi-second cold compiles
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _fmt(v: float) -> str:
    # prometheus floats: integral values without the trailing .0 noise
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _escape_label(v: Any) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition is unparsable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_key(labels: Optional[Dict[str, Any]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


class Histogram:
    """Cumulative-bucket histogram (Prometheus `histogram` type).

    Quantiles are estimated from the bucket counts (each returns the
    upper bound of the bucket containing the quantile — the standard
    `histogram_quantile` resolution, good enough for p50/p95/p99
    dashboards without keeping samples)."""

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = ""):
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding quantile q in [0, 1];
        0.0 when empty, the largest finite bound for the +Inf bucket."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            cum = 0
            for i, b in enumerate(self.bounds):
                cum += self.counts[i]
                if cum >= target:
                    return b
            return self.bounds[-1] if self.bounds else 0.0

    def render(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        with self._lock:
            cum = 0
            for i, b in enumerate(self.bounds):
                cum += self.counts[i]
                lines.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}')
            cum += self.counts[-1]
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{self.name}_sum {_fmt(self.sum)}")
            lines.append(f"{self.name}_count {self.count}")
        # convenience quantile gauges so dashboards don't need
        # histogram_quantile(); same data, pre-reduced
        for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lines.append(f"# TYPE {self.name}_{label} gauge")
            lines.append(f"{self.name}_{label} {_fmt(self.percentile(q))}")
        return lines


# a collector contributes families at render time:
#   () -> [(family_name, type, help, [(labels_dict_or_None, value)])]
_Collector = Callable[[], List[Tuple[str, str, str,
                                     List[Tuple[Optional[Dict], float]]]]]


class MetricsRegistry:
    """Histograms, counters (optionally labeled), gauge callables, stat
    sets, and render-time collectors behind one compliant renderer.

    Names here are FULL metric names: namespacing is the caller's job
    (runtime families use `pt_`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._histograms: Dict[str, Histogram] = {}
        # family -> labelkey -> value; () is the unlabeled series
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._help: Dict[str, str] = {}
        self._gauges: Dict[str, Tuple[Callable[[], Any], str]] = {}
        self._stat_sets: List[Tuple[str, Any]] = []  # (prefix, StatSet)
        self._collectors: List[_Collector] = []

    # -- registration ---------------------------------------------------
    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  help: str = "") -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, buckets, help)
            return h

    def declare_counter(self, name: str, help: str = "",
                        labels: Optional[Dict[str, Any]] = None) -> None:
        """Pre-register a counter at 0 so the series exists on the very
        first scrape (components declare their counters at construction
        — a scraper must never see a family appear mid-flight)."""
        key = _label_key(labels)
        with self._lock:
            fam = self._counters.setdefault(name, {})
            fam.setdefault(key, 0.0)
            if help:
                self._help.setdefault(name, help)

    def counter_inc(self, name: str, by: float = 1.0, help: str = "",
                    labels: Optional[Dict[str, Any]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            fam = self._counters.setdefault(name, {})
            fam[key] = fam.get(key, 0.0) + by
            if help:
                self._help.setdefault(name, help)

    def counter_value(self, name: str,
                      labels: Optional[Dict[str, Any]] = None) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels), 0.0)

    def gauge(self, name: str, fn: Callable[[], Any],
              help: str = "") -> None:
        """Gauges are callables evaluated at scrape time — the
        instrumented component owns the value, the registry only reads
        it. Registering an existing name replaces it (a rebuilt trainer
        or engine takes the series over). A callable returning None
        skips the series for that scrape (e.g. a dead weakref)."""
        with self._lock:
            self._gauges[name] = (fn, help)

    def attach_stat_set(self, stat_set, prefix: str = "pt_timer_") -> None:
        """Render a profiler.StatSet's timers as counter pairs
        `<prefix><name>_seconds_total` / `<prefix><name>_count`."""
        with self._lock:
            for p, s in self._stat_sets:
                if p == prefix and s is stat_set:
                    return
            self._stat_sets.append((prefix, stat_set))

    def add_collector(self, fn: _Collector) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn: _Collector) -> None:
        """Detach a render-time collector (a closed Router takes its fleet
        families with it)."""
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def remove_series(self, name: str, labels: Optional[Dict[str, Any]] = None) -> bool:
        """Drop ONE labeled series of a counter family (the family stays
        while any series remains): a replica scaled down or rolled away takes
        its `{replica="..."}` series with it. True when the series existed."""
        key = _label_key(labels)
        with self._lock:
            fam = self._counters.get(name)
            if fam is None or key not in fam:
                return False
            del fam[key]
            if not fam:
                del self._counters[name]
                self._help.pop(name, None)
            return True

    # -- export ---------------------------------------------------------
    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            hists = list(self._histograms.values())
            counters = sorted((n, dict(series))
                              for n, series in self._counters.items())
            helps = dict(self._help)
            gauges = sorted(self._gauges.items())
            stat_sets = list(self._stat_sets)
            collectors = list(self._collectors)
        for h in hists:
            lines.extend(h.render())
        for name, series in counters:
            self._family(lines, name, "counter", helps.get(name, ""),
                         [(k, v) for k, v in sorted(series.items())])
        for name, (fn, help) in gauges:
            try:
                v = fn()
            except Exception:
                v = float("nan")
            if v is None:
                continue  # dead source: skip the series this scrape
            self._family(lines, name, "gauge", help, [((), float(v))])
        for prefix, ss in stat_sets:
            lines.extend(self._render_stat_set(prefix, ss))
        for coll in collectors:
            try:
                fams = coll()
            except Exception:
                continue  # a broken collector must not break the scrape
            for name, typ, help, samples in fams:
                self._family(
                    lines, name, typ, help,
                    [(_label_key(lb), float(v)) for lb, v in samples])
        return "\n".join(lines) + "\n"

    @staticmethod
    def _family(lines: List[str], name: str, typ: str, help: str,
                samples: List[Tuple[_LabelKey, float]]) -> None:
        """One family: HELP/TYPE exactly once, then every series."""
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {typ}")
        for key, v in samples:
            lines.append(f"{name}{_render_labels(key)} {_fmt(v)}")

    def _render_stat_set(self, prefix: str, ss) -> List[str]:
        lines: List[str] = []
        for name, s in sorted(ss.as_dict().items()):
            metric = f"{prefix}{_sanitize(name)}"
            self._family(lines, f"{metric}_seconds_total", "counter", "",
                         [((), s["total"])])
            self._family(lines, f"{metric}_count", "counter", "",
                         [((), s["count"])])
        return lines


# -- the process-wide registry ----------------------------------------------

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """THE process-wide registry: the trainer's counters and the runtime
    collectors land here; the periodic training stats line renders it."""
    return _REGISTRY


# -- built-in runtime collectors --------------------------------------------

def _faults_families():
    import sys

    faults = sys.modules.get("paddle_tpu_torch.resilience.faults")
    if faults is None:
        return []
    st = faults.stats()
    if not st:
        return []
    return [
        ("pt_fault_hits_total", "counter",
         "fault-point hits (resilience.faults)",
         [({"point": p}, d["hits"]) for p, d in st.items()]),
        ("pt_fault_fired_total", "counter",
         "fault-point triggers (resilience.faults)",
         [({"point": p}, d["fired"]) for p, d in st.items()]),
    ]


def _trace_families():
    from . import trace

    return [
        ("pt_trace_dropped_total", "counter",
         "trace events dropped to ring-buffer overflow (obs.trace)",
         [(None, trace.dropped_total())]),
        ("pt_trace_armed", "gauge",
         "1 while a span-tracing capture is active",
         [(None, 1.0 if trace.armed() else 0.0)]),
    ]


def _statset_families():
    """The global StatSet rides the unified render even though it is
    not attach_stat_set'ed (reset_metrics would drop the attachment;
    the global table must always be scrapeable)."""
    import sys

    profiler = sys.modules.get("paddle_tpu_torch.profiler")
    if profiler is None:
        return []
    out = []
    for name, s in sorted(profiler.global_stat_set().as_dict().items()):
        metric = f"pt_timer_{_sanitize(name)}"
        out.append((f"{metric}_seconds_total", "counter", "",
                    [(None, s["total"])]))
        out.append((f"{metric}_count", "counter", "", [(None, s["count"])]))
    return out


_REGISTRY.add_collector(_faults_families)
_REGISTRY.add_collector(_trace_families)
_REGISTRY.add_collector(_statset_families)
