"""Structured span tracing: bounded per-thread rings, Chrome trace export
(paddle_tpu/obs/trace.py:94-476, the same design and the same export).

- Disarmed (the default), every hook returns after ONE module-global
  boolean test: no allocation, no clock read. Call sites on hot loops
  guard kwargs-building work behind `_armed`.
- Armed (`PT_FLAGS_TRACE=<out.json>` or the scoped `obs.tracing()`
  context), spans record into BOUNDED per-thread ring buffers (no
  cross-thread contention on the record path; overflow drops the OLDEST
  events and counts them in `dropped_total()`, exported as the
  `pt_trace_dropped_total` counter).
- Timestamps come from one monotonic clock (`time.perf_counter`), so spans
  across threads order correctly in the exported timeline.
- Correlation travels as a per-thread trace context (a plain dict):
  `set_context(step=..)` attaches ids every later span on that thread
  records as args; a thread hand-off copies it explicitly
  (`get_context()` on the producer, `set_context(**ctx)` on the consumer),
  which is how step ids flow prefetch -> step -> hostSync -> checkpoint.
  The serving stack mints request ids with `new_request_id` and records
  each on its queue, admission, pool-step and stream spans, so one key
  joins them across threads; `context(request_id=..)` scopes an id over a
  block and restores the previous one.
  Under the Trainer's scan_window the context is the window's (`window`,
  its first batch, and `k`) and one forwardBackward span covers the
  window's k steps; the prefetcher stacks each window in a
  `prefetch.window` span.
- Export is Chrome trace-event JSON ("X" complete events, "i" instants,
  "C" counter tracks, "M" thread names) for Perfetto / chrome://tracing.
  `tracing(profile_dir=...)` brackets the capture inside
  `profiler.profiler()` (torch.profiler), so host spans and the card's
  kernels cover the same interval.

`profiler.StatSet.timer` integrates: while tracing is armed every timer
block (forwardBackward, hostSync, checkpointSnapshot) also records a span.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..flags import FLAGS, define_flag

__all__ = [
    "Trace",
    "arm",
    "armed",
    "context",
    "counter",
    "disarm",
    "dropped_total",
    "get_context",
    "instant",
    "new_request_id",
    "set_context",
    "span",
    "tracing",
    "validate_chrome_trace",
]

define_flag("trace", "",
            "arm structured span tracing and export a Chrome trace-event "
            "JSON (Perfetto / chrome://tracing) to this path at process "
            "exit (env: PT_FLAGS_TRACE; scoped "
            "captures: paddle_tpu_torch.obs.tracing()). Empty = tracing "
            "disarmed and every trace hook a single-boolean-test no-op")
define_flag("trace_ring", 65536,
            "per-thread trace ring capacity in events; overflow drops "
            "the oldest events and counts them in pt_trace_dropped_total")

# the fast-path gate, exactly like resilience.faults._armed: when False
# every public hook returns after one module-global boolean test
_armed = False
_trace: Optional["Trace"] = None
_lock = threading.Lock()
_req_ids = itertools.count(1)
_dropped_closed = 0  # drops accumulated by finished captures


class _NullSpan:
    """Singleton no-op context manager returned by span() while
    disarmed — no per-call allocation on the disarmed path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _ThreadBuf:
    """One thread's ring: events, open-span stack, and trace context.

    Single-writer by construction (only its own thread appends), so the
    record path is lock-free; the exporter snapshots under the trace
    lock after the run quiesces."""

    __slots__ = ("tid", "name", "events", "stack", "ctx", "dropped")

    def __init__(self, ring: int):
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.name = t.name
        self.events: collections.deque = collections.deque(maxlen=ring)
        self.stack: List[tuple] = []  # open spans: (name, cat, t0, args)
        self.ctx: Dict[str, Any] = {}
        self.dropped = 0

    def push(self, ev: tuple) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1  # deque drops the oldest on append
        self.events.append(ev)


class _Span:
    __slots__ = ("_name", "_cat", "_args")

    def __init__(self, name, cat, args):
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        _begin(self._name, self._cat, self._args)
        return self

    def __exit__(self, *exc):
        _end()
        return False


class Trace:
    """One capture: per-thread rings + the export machinery."""

    def __init__(self, ring_size: Optional[int] = None):
        self.ring_size = int(ring_size or FLAGS.trace_ring)
        if self.ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {self.ring_size}")
        self.t0 = time.perf_counter()
        self._tls = threading.local()
        self._bufs: List[_ThreadBuf] = []
        self._bufs_lock = threading.Lock()

    # -- record side (called via the module-level hooks) ----------------
    def buf(self) -> _ThreadBuf:
        b = getattr(self._tls, "buf", None)
        if b is None:
            b = _ThreadBuf(self.ring_size)
            self._tls.buf = b
            with self._bufs_lock:
                self._bufs.append(b)
        return b

    # -- accounting -----------------------------------------------------
    def dropped_total(self) -> int:
        with self._bufs_lock:
            return sum(b.dropped for b in self._bufs)

    def event_count(self) -> int:
        with self._bufs_lock:
            return sum(len(b.events) for b in self._bufs)

    # -- export ---------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (the "JSON Object Format":
        {"traceEvents": [...]}). Open spans on any thread are closed at
        export time so a mid-run snapshot still validates."""
        pid = os.getpid()
        now = time.perf_counter()
        events: List[Dict[str, Any]] = []
        with self._bufs_lock:
            bufs = list(self._bufs)
        for b in bufs:
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": b.tid, "args": {"name": b.name},
            })
            for ev in list(b.events):
                events.append(self._event_json(ev, pid, b.tid))
            # spans still open (e.g. export inside the traced region):
            # close them at "now" so the JSON stays schema-valid
            for name, cat, t0, args in b.stack:
                events.append(self._event_json(
                    ("X", name, cat, t0, now - t0, dict(b.ctx, **(args or {}))),
                    pid, b.tid))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped_total()},
        }

    def _event_json(self, ev: tuple, pid: int, tid: int) -> Dict[str, Any]:
        ph = ev[0]
        us = 1e6
        if ph == "X":
            _, name, cat, t0, dur, args = ev
            out = {"ph": "X", "name": name, "cat": cat, "pid": pid,
                   "tid": tid, "ts": (t0 - self.t0) * us,
                   "dur": max(0.0, dur) * us}
            if args:
                out["args"] = args
            return out
        if ph == "i":
            _, name, cat, t, args = ev
            out = {"ph": "i", "name": name, "cat": cat, "pid": pid,
                   "tid": tid, "ts": (t - self.t0) * us, "s": "t"}
            if args:
                out["args"] = args
            return out
        # counter track
        _, name, t, value = ev
        return {"ph": "C", "name": name, "pid": pid, "tid": tid,
                "ts": (t - self.t0) * us, "args": {"value": value}}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path."""
        doc = self.to_chrome()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# -- module-level hooks (the instrumented call sites) -----------------------

def armed() -> bool:
    return _armed


def arm(out: Optional[str] = None,
        ring_size: Optional[int] = None) -> Trace:
    """Start a capture (idempotent while one is active). `out`
    only records the default export path used by disarm()/atexit."""
    global _armed, _trace
    with _lock:
        if _trace is None:
            _trace = Trace(ring_size=ring_size)
            _trace.out = out  # type: ignore[attr-defined]
            _armed = True
        elif out:
            _trace.out = out  # type: ignore[attr-defined]
        return _trace


def disarm(export: bool = True) -> Optional[Trace]:
    """End the capture; export to its recorded path (if any)
    and return the Trace for programmatic inspection."""
    global _armed, _trace, _dropped_closed
    with _lock:
        tr, _trace = _trace, None
        _armed = False
    if tr is not None:
        _dropped_closed += tr.dropped_total()
        out = getattr(tr, "out", None)
        if export and out:
            tr.export(out)
    return tr


def dropped_total() -> int:
    """Events dropped to ring overflow, across all captures of
    this process (monotonic; the pt_trace_dropped_total counter)."""
    tr = _trace
    return _dropped_closed + (tr.dropped_total() if tr is not None else 0)


@contextlib.contextmanager
def tracing(out: Optional[str] = None, ring_size: Optional[int] = None,
            profile_dir: Optional[str] = None):
    """Scoped capture: arm, yield the Trace, export+disarm on exit.

    profile_dir brackets the capture in profiler.profiler() (a
    torch.profiler trace written there), so host spans and the card's
    kernels are captured over the same interval (correlate the two
    timelines by wall offset)."""
    tr = arm(out=out, ring_size=ring_size)
    stack = contextlib.ExitStack()
    if profile_dir:
        from .. import profiler as _profiler

        stack.enter_context(_profiler.profiler(profile_dir))
    try:
        with stack:
            yield tr
    finally:
        disarm(export=True)


def _begin(name: str, cat: str = "host",
           args: Optional[Dict[str, Any]] = None) -> None:
    tr = _trace
    if tr is None:
        return
    tr.buf().stack.append((name, cat, time.perf_counter(), args))


def _end() -> None:
    tr = _trace
    if tr is None:
        return
    b = tr.buf()
    if not b.stack:
        return  # span begun before arm / ended twice: drop, don't crash
    name, cat, t0, args = b.stack.pop()
    t1 = time.perf_counter()
    merged = dict(b.ctx)
    if args:
        merged.update(args)
    b.push(("X", name, cat, t0, t1 - t0, merged or None))


def span(name: str, cat: str = "host", **args):
    """Context manager recording one span. Disarmed: returns the no-op
    singleton. (Building `args` still costs a dict at the call site —
    hot loops must guard with `if trace.armed():`.)"""
    if not _armed:
        return _NULL
    return _Span(name, cat, args)


def instant(name: str, cat: str = "host", **args) -> None:
    """Point event (phase "i")."""
    if not _armed:
        return
    tr = _trace
    if tr is None:
        return
    b = tr.buf()
    merged = dict(b.ctx)
    if args:
        merged.update(args)
    b.push(("i", name, cat, time.perf_counter(), merged or None))


def counter(name: str, value: float) -> None:
    """Counter-track sample (phase "C"): queue depth, slot occupancy."""
    if not _armed:
        return
    tr = _trace
    if tr is None:
        return
    tr.buf().push(("C", name, time.perf_counter(), float(value)))


def set_context(**ids: Any) -> None:
    """Merge correlation ids into this thread's trace context; every
    subsequent span/instant on this thread records them as args.
    A None value removes the key."""
    if not _armed:
        return
    tr = _trace
    if tr is None:
        return
    ctx = tr.buf().ctx
    for k, v in ids.items():
        if v is None:
            ctx.pop(k, None)
        else:
            ctx[k] = v


def get_context() -> Dict[str, Any]:
    """Snapshot of this thread's trace context (for explicit hand-off
    to another thread); {} while disarmed."""
    if not _armed:
        return {}
    tr = _trace
    if tr is None:
        return {}
    return dict(tr.buf().ctx)


@contextlib.contextmanager
def context(**ids: Any):
    """Scoped set_context: sets ids on entry, restores the previous values
    on exit (worker loops that serve many requests)."""
    if not _armed:
        yield
        return
    tr = _trace
    if tr is None:
        yield
        return
    ctx = tr.buf().ctx
    saved = {k: ctx.get(k, _MISSING) for k in ids}
    set_context(**ids)
    try:
        yield
    finally:
        buf_ctx = tr.buf().ctx
        for k, v in saved.items():
            if v is _MISSING:
                buf_ctx.pop(k, None)
            else:
                buf_ctx[k] = v


_MISSING = object()


def new_request_id(prefix: str = "req") -> str:
    """Process-unique request id ("req-17"): assigned at admission so every
    span a request touches, across threads, carries one key."""
    return f"{prefix}-{next(_req_ids)}"


# -- schema ------------------------------------------------------------------

_PHASES = {"X", "i", "C", "M"}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Validate a loaded Chrome trace-event JSON object against the
    subset of the trace-event format this exporter emits. Returns a
    list of problems (empty = valid). Used by the test suite's
    schema check and by `tracing()` consumers that want a cheap
    sanity gate before shipping a trace somewhere."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a traceEvents list"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            problems.append(f"{where}: pid/tid must be ints")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be an object")
    return problems


# -- env-seeded arming (subprocesses traced from birth, like faults) --------

if FLAGS.trace:
    arm(out=FLAGS.trace)
    atexit.register(lambda: disarm(export=True))
