"""Dynamic micro-batcher: coalesce concurrent requests into one engine call
(paddle_tpu/serving/batcher.py).

One padded batch costs about what one row costs on the card at serving
batch sizes, so K concurrent single-row requests served as one batch cost
about 1/K of the device time each.

- `submit()` appends to a BOUNDED queue and returns a Future. A full queue
  sheds load at once (`ShedError`, HTTP 503) instead of letting latency
  collapse into an unbounded backlog.
- One worker thread takes the oldest request, opens a window of
  `max_wait_ms`, and coalesces every compatible request (the same non-batch
  feed signature) that arrives inside it, up to `max_batch_size` rows.
  Incompatible requests stay queued for the next round.
- Each request carries a deadline (`timeout_ms` from submit). A request
  found expired at dispatch fails with `DeadlineError` (HTTP 504) without
  touching the device, and the deadline is checked again after the engine
  call, before results scatter: a request that waited out its deadline
  inside a bucket's first run gets a clean 504, never a late 200.
- Results scatter back by row offsets; an engine exception fans out to
  every request of the batch.
- An optional per-model CircuitBreaker sits in front of the queue.
- `AdmissionQueue`, the shed and deadline contract factored out, is shared
  with the continuous scheduler and tiered by SLO class (fleetctl.tenancy).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Dict, List, Optional

import numpy as np

from ..fleetctl.tenancy import BATCH, INTERACTIVE, SLO_CLASSES
from ..obs import trace as obs_trace
from ..resilience.breaker import CircuitBreaker, CircuitOpenError
from .engine import ServingEngine
from .metrics import MetricSet

__all__ = ["MicroBatcher", "AdmissionQueue", "ShedError", "DeadlineError",
           "CircuitOpenError"]


def _declare_slo_counters(metrics: MetricSet) -> None:
    """Fleet-wide per-class admission accounting: ONE pt_-prefixed
    family pair on the unified registry (not per-model namespaced), so
    an autoscaler or an operator reads 'is the batch tier absorbing
    the pressure?' from a single pair of labeled series."""
    for cls in SLO_CLASSES:
        metrics.registry.declare_counter(
            "pt_slo_admitted_total",
            help="requests admitted to a serving queue, by SLO class",
            labels={"slo": cls})
        metrics.registry.declare_counter(
            "pt_slo_shed_total",
            help="requests shed (queue pressure), by SLO class — the "
                 "shed order is strictly batch-first",
            labels={"slo": cls})


def _slo_count(metrics: MetricSet, name: str, cls: str) -> None:
    metrics.registry.counter_inc(name, labels={"slo": cls})


class ShedError(RuntimeError):
    """Queue at capacity: the request was rejected, not enqueued."""


class DeadlineError(RuntimeError):
    """The request's deadline passed before dispatch."""


class AdmissionQueue:
    """Bounded, deadline-aware, TWO-LEVEL priority FIFO — the admission
    half of the MicroBatcher contract factored out so the generation
    path's token-level scheduler shares the SAME shed/deadline
    semantics, now tiered by SLO class (fleetctl.tenancy):

    - one FIFO per class (`interactive`, `batch`); `pop()` serves the
      interactive tier to exhaustion before touching batch, each tier
      oldest-first.
    - `put()` admits while total depth < `max_queue`. At capacity the
      shed order is STRICTLY batch-first: an arriving interactive
      request displaces the NEWEST queued batch request (which fails
      with a retryable ShedError) — an interactive request is shed
      only when the entire queue is already interactive; an arriving
      batch request at capacity is shed immediately. Invariant (pinned
      by a property test): no interactive request is ever shed while
      any batch request occupies the queue.
    - `pop()` hands back the oldest request of the best class;
      requests found expired are failed with DeadlineError (504) via
      their `fail()` and counted as `<prefix>deadline_exceeded_total`
      — and, exactly like MicroBatcher's post-engine re-check, the
      consumer is expected to RE-CHECK `deadline` after slot
      admission / dispatch so a request never receives a late first
      token its client already gave up on (`expire()` is that
      re-check's failure path).

    Items need two attributes: `deadline` (monotonic seconds) and
    `fail(exc)` (terminal failure delivery); an optional `slo_class`
    ("interactive" when absent) selects the tier, and `enqueued_at` is
    stamped at admission so /healthz can report the age of the oldest
    queued request. The caller supplies the Condition so one lock can
    cover queue state plus whatever else the consumer's worker loop
    sleeps on (e.g. decode-slot occupancy)."""

    def __init__(self, max_queue: int, cond: threading.Condition,
                 metrics: MetricSet, prefix: str = ""):
        self.max_queue = max_queue
        self.cond = cond
        self.metrics = metrics
        self.prefix = prefix
        self._tiers: Dict[str, collections.deque] = {
            cls: collections.deque() for cls in SLO_CLASSES}
        # pre-registered so scrapers see the series at 0, not appearing
        # on the first shed/expiry
        metrics.declare_counter(
            f"{prefix}shed_total",
            help="requests rejected because the queue was full")
        metrics.declare_counter(
            f"{prefix}deadline_exceeded_total",
            help="requests that expired before their result")
        _declare_slo_counters(metrics)

    def __len__(self) -> int:
        with self.cond:
            return sum(len(q) for q in self._tiers.values())

    def depth(self) -> int:
        # advisory (gauges); exact depth needs the cond
        return sum(len(q) for q in self._tiers.values())

    def depth_by_class(self) -> Dict[str, int]:
        """Advisory per-tier depths (/healthz classes block)."""
        return {cls: len(q) for cls, q in self._tiers.items()}

    def oldest_enqueued(self) -> Optional[float]:
        """Monotonic enqueue time of the oldest queued request across
        tiers, or None when empty. Advisory (tier heads are each
        tier's oldest — FIFO within a tier)."""
        heads = []
        for q in self._tiers.values():
            try:
                heads.append(q[0].enqueued_at)
            except IndexError:
                pass
        return min(heads) if heads else None

    def _shed(self, req, cls: str, msg: str) -> None:
        """Count + fail one request as shed. Caller holds the cond."""
        self.metrics.counter_inc(
            f"{self.prefix}shed_total",
            help="requests rejected because the queue was full")
        _slo_count(self.metrics, "pt_slo_shed_total", cls)
        req.fail(ShedError(msg))

    def put(self, req) -> None:
        """Enqueue or shed (batch-first at capacity). Caller must NOT
        hold the condition. Raises ShedError when REQ itself is shed;
        a displaced batch request fails through its own `fail()`."""
        cls = getattr(req, "slo_class", None) or INTERACTIVE
        with self.cond:
            total = sum(len(q) for q in self._tiers.values())
            if total >= self.max_queue:
                batch_q = self._tiers[BATCH]
                if cls == BATCH or not batch_q:
                    # arriving batch, or a queue already pure
                    # interactive: the arrival itself is shed
                    self.metrics.counter_inc(
                        f"{self.prefix}shed_total",
                        help="requests rejected because the queue "
                             "was full")
                    _slo_count(self.metrics, "pt_slo_shed_total", cls)
                    raise ShedError(
                        f"queue full ({self.max_queue} waiting); "
                        "retry later")
                # interactive arrival displaces the NEWEST batch
                # request — the batch tier absorbs the pressure so
                # interactive never queues behind a full house
                self._shed(batch_q.pop(), BATCH,
                           "displaced by interactive admission; "
                           "retry later")
            req.enqueued_at = time.monotonic()
            self._tiers[cls].append(req)
            _slo_count(self.metrics, "pt_slo_admitted_total", cls)
            self.cond.notify_all()

    def pop(self):
        """Oldest non-expired request of the highest-priority
        non-empty tier, or None. Expired requests are failed
        (DeadlineError) and skipped. Caller holds the cond."""
        for cls in SLO_CLASSES:
            q = self._tiers[cls]
            while q:
                req = q.popleft()
                if req.deadline <= time.monotonic():
                    self.expire(req, "deadline exceeded while queued")
                    continue
                return req
        return None

    def expire(self, req, msg: str) -> None:
        """Fail one request on a missed deadline (shared by the queued
        check in pop() and the consumer's post-admission re-check)."""
        self.metrics.counter_inc(
            f"{self.prefix}deadline_exceeded_total",
            help="requests that expired before their result")
        req.fail(DeadlineError(msg))

    def drain(self, exc: Exception) -> None:
        """Fail everything still queued (shutdown/abort)."""
        with self.cond:
            for q in self._tiers.values():
                while q:
                    q.popleft().fail(exc)


class _Request:
    __slots__ = ("feed", "rows", "future", "deadline", "signature",
                 "request_id", "slo_class", "enqueued_at")

    def __init__(self, feed: Dict[str, np.ndarray], deadline: float,
                 request_id: Optional[str] = None,
                 slo_class: str = INTERACTIVE):
        self.feed = feed
        self.slo_class = slo_class
        self.enqueued_at = 0.0  # stamped at admission
        # a router-minted id (X-PT-Request-Id) is adopted so one trace
        # shows router pick → replica queue → engine call for a request;
        # locally-submitted requests mint their own
        self.request_id = request_id or obs_trace.new_request_id()
        rows = {v.shape[0] for v in feed.values() if v.ndim >= 1}
        if len(rows) != 1:
            raise ValueError(
                f"batchable feeds must share the batch axis; got row "
                f"counts {sorted(rows)}")
        self.rows = rows.pop()
        self.future: Future = Future()
        self.deadline = deadline
        # requests concat only when every non-batch extent and dtype
        # matches (the same bucket after padding)
        self.signature = tuple(
            (k, feed[k].shape[1:], feed[k].dtype.name)
            for k in sorted(feed))


class MicroBatcher:
    def __init__(
        self,
        engine: ServingEngine,
        max_batch_size: Optional[int] = None,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        timeout_ms: float = 2000.0,
        metrics: Optional[MetricSet] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.engine = engine
        self.breaker = breaker
        self.max_batch_size = (max_batch_size
                               or engine.policy.max_batch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.timeout_s = timeout_ms / 1e3
        self.metrics = metrics or engine.metrics
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._stopping = False
        self._batch_hist = self.metrics.histogram(
            "batch_rows", buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            help="rows per coalesced engine call")
        self.metrics.gauge(
            "queue_depth", lambda: len(self._q),
            help="requests waiting for dispatch")
        self.metrics.declare_counter(
            "requests_total", help="requests dispatched to the engine")
        self.metrics.declare_counter(
            "shed_total",
            help="requests rejected because the queue was full")
        self.metrics.declare_counter(
            "deadline_exceeded_total",
            help="requests that expired before dispatch")
        self.metrics.declare_counter(
            "circuit_open_total",
            help="requests rejected because the model's circuit breaker "
                 "was open")
        _declare_slo_counters(self.metrics)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._worker is not None and self._worker.is_alive():
                return self
            self._stopping = False
            self._worker = threading.Thread(
                target=self._run, name=f"ptserving-{self.engine.model_name}",
                daemon=True)
            self._worker.start()
        return self

    def stop(self, drain: bool = False) -> None:
        """Stop the worker. drain=True lets queued work finish first;
        otherwise queued requests fail with ShedError."""
        with self._cond:
            if drain:
                while self._q and self._worker and self._worker.is_alive():
                    self._cond.wait(timeout=0.05)
            self._stopping = True
            if not drain:
                while self._q:
                    req = self._q.popleft()
                    req.future.set_exception(
                        ShedError("batcher shutting down"))
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)

    # -- client side ----------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               slo: Optional[str] = None) -> Future:
        """Enqueue one request. `slo` tiers it ("interactive" default):
        the queue keeps interactive requests ahead of batch, and at
        capacity the shed order is strictly batch-first — an arriving
        interactive request displaces the newest queued batch request
        (failed with ShedError through its future) and is never itself
        shed while any batch request occupies the queue."""
        cls = slo or INTERACTIVE
        if cls not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {cls!r}; expected one of "
                f"{SLO_CLASSES}")
        req = _Request(
            feed,
            time.monotonic() + (timeout_ms / 1e3 if timeout_ms is not None
                                else self.timeout_s),
            request_id=request_id, slo_class=cls)
        if req.rows > self.max_batch_size:
            raise ValueError(
                f"request rows {req.rows} exceed max_batch_size "
                f"{self.max_batch_size}")
        if self.breaker is not None and not self.breaker.admit():
            self.metrics.counter_inc(
                "circuit_open_total",
                help="requests rejected because the model's circuit "
                     "breaker was open")
            raise CircuitOpenError(
                f"circuit open for model {self.engine.model_name!r}; "
                "retry later")
        with self._cond:
            if self._stopping:
                raise ShedError("batcher stopped")
            if len(self._q) >= self.max_queue:
                victim = None
                if cls == INTERACTIVE:
                    # newest queued batch request, scanning from the
                    # tail (the deque is interactive-first, so batch
                    # work sits at the back)
                    for i in range(len(self._q) - 1, -1, -1):
                        if self._q[i].slo_class == BATCH:
                            victim = self._q[i]
                            del self._q[i]
                            break
                if victim is None:
                    self.metrics.counter_inc(
                        "shed_total",
                        help="requests rejected because the queue "
                             "was full")
                    _slo_count(self.metrics, "pt_slo_shed_total", cls)
                    raise ShedError(
                        f"queue full ({self.max_queue} waiting); "
                        "retry later")
                self.metrics.counter_inc(
                    "shed_total",
                    help="requests rejected because the queue was full")
                _slo_count(self.metrics, "pt_slo_shed_total", BATCH)
                victim.future.set_exception(ShedError(
                    "displaced by interactive admission; retry later"))
            req.enqueued_at = time.monotonic()
            if cls == BATCH:
                self._q.append(req)
            else:
                # insert ahead of the first batch request so dispatch
                # order within the window is interactive-first
                at = len(self._q)
                for i, other in enumerate(self._q):
                    if other.slo_class == BATCH:
                        at = i
                        break
                self._q.insert(at, req)
            _slo_count(self.metrics, "pt_slo_admitted_total", cls)
            self._cond.notify()
        return req.future

    def oldest_enqueued(self) -> Optional[float]:
        """Monotonic enqueue time of the oldest queued request, or
        None when empty (/healthz queue_age_ms)."""
        with self._cond:
            if not self._q:
                return None
            return min(r.enqueued_at for r in self._q)

    def depth_by_class(self) -> Dict[str, int]:
        """Queue depth per SLO class (/healthz classes block)."""
        with self._cond:
            out = {c: 0 for c in SLO_CLASSES}
            for r in self._q:
                out[r.slo_class] += 1
            return out

    def predict(self, feed: Dict[str, np.ndarray],
                timeout_ms: Optional[float] = None,
                request_id: Optional[str] = None,
                slo: Optional[str] = None) -> List[np.ndarray]:
        """submit + wait. Raises ShedError / DeadlineError / the
        engine's exception. The wait allows the deadline plus an equal
        grace (min 1 s) for a dispatch already in flight — a bucket's
        first run may exceed the deadline alone; warm the engine (ServingEngine.warmup) to avoid
        first-request 504s."""
        fut = self.submit(feed, timeout_ms=timeout_ms,
                          request_id=request_id, slo=slo)
        budget = (timeout_ms / 1e3 if timeout_ms is not None
                  else self.timeout_s)
        try:
            return fut.result(timeout=budget + max(1.0, budget))
        except FuturesTimeout:
            self.metrics.counter_inc(
                "deadline_exceeded_total",
                help="requests that expired before dispatch")
            raise DeadlineError(
                "deadline exceeded waiting for a result") from None

    # -- worker side ----------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Block for the first request, then coalesce compatible ones
        inside the wait window. Returns [] only when stopping."""
        with self._cond:
            while not self._q and not self._stopping:
                self._cond.wait()
            if self._stopping and not self._q:
                return []
            first = self._q.popleft()
            now = time.monotonic()
            if first.deadline <= now:
                first.future.set_exception(DeadlineError(
                    "deadline exceeded while queued"))
                self.metrics.counter_inc(
                    "deadline_exceeded_total",
                    help="requests that expired before dispatch")
                return self._NOTHING
            batch = [first]
            rows = first.rows
            window_end = now + self.max_wait_s
            while rows < self.max_batch_size:
                # scan the queue for compatible requests; leave others
                picked = None
                for i, req in enumerate(self._q):
                    if req.deadline <= time.monotonic():
                        del self._q[i]
                        req.future.set_exception(DeadlineError(
                            "deadline exceeded while queued"))
                        self.metrics.counter_inc(
                            "deadline_exceeded_total",
                            help="requests that expired before dispatch")
                        picked = self._RESCAN
                        break
                    if (req.signature == first.signature
                            and rows + req.rows <= self.max_batch_size):
                        del self._q[i]
                        picked = req
                        break
                if picked is self._RESCAN:
                    continue
                if picked is not None:
                    batch.append(picked)
                    rows += picked.rows
                    continue
                remaining = window_end - time.monotonic()
                if remaining <= 0 or self._stopping:
                    break
                self._cond.wait(timeout=remaining)
            return batch

    _RESCAN = object()
    _NOTHING: List[_Request] = []

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._cond:
                    if self._stopping and not self._q:
                        self._cond.notify_all()
                        return
                continue
            self._dispatch(batch)
            with self._cond:
                self._cond.notify_all()  # wake stop(drain=True) waiters

    def _dispatch(self, batch: List[_Request]) -> None:
        if obs_trace._armed:
            # the coalesced call is the correlation point of the predict
            # path: one span carrying every member request's id, on the
            # batcher worker thread
            obs_trace.set_context(
                request_id=",".join(r.request_id for r in batch))
        try:
            if len(batch) == 1:
                feed = batch[0].feed
            else:
                feed = {
                    k: np.concatenate([r.feed[k] for r in batch], axis=0)
                    for k in batch[0].feed
                }
            total = sum(r.rows for r in batch)
            self._batch_hist.observe(total)
            self.metrics.counter_inc(
                "requests_total", by=len(batch),
                help="requests dispatched to the engine")
            outs = self.engine.predict(feed)
        except Exception as e:  # fan the failure out, keep serving
            if self.breaker is not None:
                self.breaker.record_failure()
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        if self.breaker is not None:
            self.breaker.record_success()
        # deadline re-check AFTER the engine call: a bucket's first run
        # can outlast a request's deadline — the client that
        # already gave up must see a clean 504, not a late 200
        now = time.monotonic()
        off = 0
        for r in batch:
            sliced = [
                o[off:off + r.rows]
                if (hasattr(o, "ndim") and o.ndim >= 1
                    and o.shape[0] == total) else o
                for o in outs
            ]
            off += r.rows
            if r.deadline <= now:
                self.metrics.counter_inc(
                    "deadline_exceeded_total",
                    help="requests that expired before dispatch")
                r.future.set_exception(DeadlineError(
                    "deadline exceeded during the engine run (a "
                    "bucket's first run? warm the engine)"))
            else:
                r.future.set_result(sliced)
