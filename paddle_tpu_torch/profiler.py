"""Profiling: stat timers, the card's trace, parameter stats
(paddle_tpu/profiler.py:38-230).

- `Stat`/`StatSet` (REGISTER_TIMER parity, utils/Stat.h:63-242): named host
  timers accumulating count/total/max; the global set
  (`global_stat_set`, `timer`) is what the trainer's forwardBackward,
  hostSync, prepareBatchData and checkpointSnapshot blocks feed.
- `profiler()` wraps torch.profiler (CPU and CUDA activities) and writes a
  Chrome trace of the block, kernels included, into `output_dir`.
- `parameter_stats`: per-parameter value/gradient statistics
  (TrainerInternal.cpp:81-109).

CUDA launches are asynchronous, so a timer around device work times the
host's view of it: the enqueue, plus any wait the block itself causes.
The trainer's `forwardBackward` brackets only the enqueue of a step, and
`hostSync` brackets the periodic device-to-host read of the on-device
accumulator, which is where the card's time surfaces: the host-blocked
fraction of a run is hostSync.total over wall time. No timer here
synchronizes; to time device work in a block, read a result inside it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from .flags import FLAGS
from .obs import trace as _trace


class Stat:
    __slots__ = ("name", "count", "total", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        # the step loop and the background checkpoint writer land in the
        # same Stat concurrently; count/total updates must not tear
        self._lock = threading.Lock()

    def add(self, dt: float) -> None:
        with self._lock:
            self.count += 1
            self.total += dt
            self.max = max(self.max, dt)

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class StatSet:
    """Named timer accumulator (reference: StatSet, Stat.h:230).
    Thread-safe: `get` guards the dict insertion and `Stat.add` its own
    accumulation (the step loop and the checkpoint writer share the
    global set)."""

    def __init__(self):
        self.stats: Dict[str, Stat] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> Stat:
        s = self.stats.get(name)
        if s is None:
            with self._lock:
                s = self.stats.get(name)
                if s is None:
                    s = self.stats[name] = Stat(name)
        return s

    @contextlib.contextmanager
    def timer(self, name: str, always: bool = False):
        """RAII timer (REGISTER_TIMER parity). No-op unless
        FLAGS.enable_timers or always=True, or span tracing is armed
        (obs.trace), in which case the block also records a span on this
        thread's trace ring (the timer vocabulary IS the span
        vocabulary)."""
        traced = _trace._armed
        if not (always or FLAGS.enable_timers or traced):
            yield
            return
        if traced:
            _trace._begin(name, "timer")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if traced:
                _trace._end()
            if always or FLAGS.enable_timers:
                self.get(name).add(dt)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """Point-in-time snapshot (the metrics registry renders it in
        Prometheus text format)."""
        return {name: {"count": s.count, "total": s.total, "avg": s.avg, "max": s.max}
                for name, s in list(self.stats.items())}

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()


_global_stats = StatSet()


def global_stat_set() -> StatSet:
    return _global_stats


def timer(name: str, always: bool = False):
    return _global_stats.timer(name, always)


@contextlib.contextmanager
def profiler(output_dir: str, state: str = "All"):
    """Deep-trace context (fluid profiler.profiler() parity): torch.profiler
    over the block, CPU and, where there is a card, CUDA activities; on
    exit the Chrome trace is written to `output_dir/trace.json`. `state`
    takes the reference's "CPU"/"GPU"/"All". Yields the profile object."""
    from torch.profiler import ProfilerActivity, profile

    acts = []
    if state in ("CPU", "All"):
        acts.append(ProfilerActivity.CPU)
    if state in ("GPU", "All") and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if not acts:
        raise ValueError(f"state {state!r}: no activity to profile here")
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(output_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(output_dir, "trace.json"))


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().float().cpu()


def parameter_stats(program=None, scope=None,
                    grads: Optional[Dict[str, Any]] = None) -> Dict[str, Dict[str, float]]:
    """Per-parameter value/gradient stats (TrainerInternal.cpp:81-109):
    mean/abs-max of each parameter; gradient stats come from `grads`
    (param name -> tensor, fetched from the step) or, failing that, the
    scope. Reads every value back to the host."""
    from .core.executor import global_scope
    from .core.program import default_main_program, grad_var_name

    program = program or default_main_program()
    scope = scope or global_scope()
    grads = grads or {}
    out: Dict[str, Dict[str, float]] = {}
    for p in program.parameters():
        if not scope.has(p.name):
            continue
        v = _host(scope.get(p.name))
        d = {"mean": float(v.mean()), "abs_max": float(v.abs().max())}
        g = grad_var_name(p.name)
        gv = None
        if p.name in grads:
            gv = _host(grads[p.name])
        elif scope.has(g):
            gv = _host(scope.get(g))
        if gv is not None:
            d["grad_mean"] = float(gv.mean())
            d["grad_abs_max"] = float(gv.abs().max())
        out[p.name] = d
    return out
