"""Scale-out serving: a load-aware router over N replica processes
(paddle_tpu/serving/router.py).

Reference lineage: the Go master dispatches task shards to a trainer
fleet and re-dispatches when a trainer dies (PAPER.md's distributed
story — etcd discovery, health leases, failover). The serving rebuild
needs the same shape on the INFERENCE side: one `serving/server.py`
process is one chip's worth of QPS no matter how fast its continuous
batcher runs, so "millions of users" means a
front-end that spreads `/predict` and `/generate` over a fleet and
survives any one replica dying mid-request.

Layers, bottom-up:

- `ReplicaClient`  — the router's view of one replica: its base URL, a
  per-replica CircuitBreaker (resilience.breaker — the containment the
  reference delegated to etcd leases), the last health snapshot (queue
  depth, slot occupancy from the replica's /healthz `load` block), and
  a router-local in-flight counter.
- `Router`         — join-shortest-queue picking over admitted
  replicas (`pick()` is PURE in-memory state: an AST lint bans
  blocking I/O in the pick hot path), dispatch with
  retry-on-other-replica for shed/503 and transport errors, chunked
  NDJSON streaming pass-through, a background health-probe loop that
  feeds snapshots and re-admits recovered replicas through the
  breaker's half-open probe, and fleet gauges/counters in the unified
  obs.MetricsRegistry (`pt_replica_up{replica=}`, routed/retried/
  failed-over counters) so ONE /metrics scrape on the router covers
  the fleet.
- `RouterServer`   — threaded stdlib-HTTP front-end: POST /predict*
  and /generate* forward; GET /healthz /stats /metrics answer locally.
- `ReplicaProcess` — a spawned `python -m paddle_tpu_torch serve` subprocess
  (port 0, URL parsed from its startup line) with ready-wait and
  kill/terminate for chaos tests.
- `WarmPool`       — pre-forked, warmed standby replicas so a traffic
  spike (or a SIGKILLed replica) is absorbed by promotion, not by a
  cold model load + warmup in the serving path.
- `Fleet`          — N managed replicas + router + a supervisor loop
  that notices dead replica processes, trips their breaker, and
  promotes a standby from the warm pool; `cli serve --replicas N`
  builds one.

Correlation: the router mints (or forwards) `X-PT-Request-Id`; the
replica adopts it for its batcher/scheduler request id, so one armed
trace capture shows router pick → replica queue → pool step → stream
for a single request across BOTH processes' exports.

Status mapping at the router: a replica's 503 (shed / its own model
breaker) triggers a retry on the next-best replica; transport errors
feed the replica's breaker and fail over the same way; only when every
admitted replica has been tried does the client see a 503 (always with
Retry-After — the fleet being saturated is retryable by contract).
Non-503 replica responses (200/400/404/500/504) relay verbatim: they
prove the replica is alive, and re-running a deadline-blown or
model-failing request elsewhere would double device work for the same
outcome.
"""

from __future__ import annotations

import collections
import http.client
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..fleetctl.tenancy import SLO_HEADER, SLOPolicy, resolve_class
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..resilience.breaker import STATE_CODES, CircuitBreaker
from .server import REQUEST_ID_HEADER

__all__ = [
    "Fleet",
    "NoReplicaError",
    "ReplicaClient",
    "ReplicaProcess",
    "Router",
    "RouterServer",
    "WarmPool",
    "make_router_server",
]


class NoReplicaError(RuntimeError):
    """Every replica is open-circuited, excluded, or absent: the
    request was not dispatched anywhere (router answers 503 +
    Retry-After — retryable by contract)."""


class ReplicaClient:
    """The router's view of one replica. All fields the pick hot path
    reads are plain attributes updated by the probe loop / dispatch
    bookkeeping — `score()` never touches the network."""

    def __init__(self, name: str, url: str,
                 breaker: Optional[CircuitBreaker] = None,
                 process: Optional["ReplicaProcess"] = None,
                 phase: Optional[str] = None):
        if phase not in (None, "prefill", "decode"):
            raise ValueError(f"replica phase must be None, 'prefill' or "
                             f"'decode', got {phase!r}")
        self.name = name
        self.phase = phase     # disagg replica class (None = monolithic)
        self.url = url.rstrip("/")
        m = re.match(r"https?://([^/:]+):(\d+)", self.url)
        if not m:
            raise ValueError(f"replica url must be http://host:port, "
                             f"got {url!r}")
        self.host, self.port = m.group(1), int(m.group(2))
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout_s=2.0)
        self.process = process
        self.inflight = 0          # router-local dispatched-not-done
        self.up = False            # last probe outcome
        self.draining = False      # retiring (rollout/scale-down):
        #                            finishes in-flight work, never
        #                            picked for new requests
        self.snapshot: Dict[str, Any] = {}  # /healthz "load" block
        self.versions: Dict[str, str] = {}  # /healthz model→fingerprint
        self.last_probe_s = 0.0
        self.last_picked = 0       # pick-sequence tie-break (JSQ ties
        #                            round-robin instead of pile-on)

    def score(self, slo: Optional[str] = None) -> float:
        """Join-shortest-queue load score: router-tracked in-flight
        (fresh, covers the probe staleness window) plus the replica's
        last-reported queue depth and active slots. With `slo` given
        and a per-class breakdown in the snapshot, the CLASS's own
        queue depth is scored instead of the total — a replica whose
        backlog is all batch work still looks short to interactive
        traffic (the batch tier sheds for it on admission). Lower =
        less loaded. Pure reads — no I/O, no locks.

        Phase-classed replicas (serving/disagg) score on their OWN
        phase's signal: a prefill replica on queue depth + compute
        backlog (queue age — its decode pool never fills, so slots are
        meaningless), a decode replica on how few FREE slots remain
        (the shipped request is about to occupy one; in-flight covers
        the handoff window before a probe refreshes the snapshot)."""
        snap = self.snapshot
        depth: Optional[float] = None
        if slo is not None:
            classes = snap.get("classes")
            if isinstance(classes, dict) and slo in classes:
                depth = float(classes[slo])
        if depth is None:
            depth = float(snap.get("queue_depth", 0))
        if self.phase == "prefill":
            return (2.0 * self.inflight
                    + depth
                    + 0.001 * float(snap.get("queue_age_ms", 0.0)))
        if self.phase == "decode":
            free = max(0.0, float(snap.get("max_slots", 0))
                       - float(snap.get("active_slots", 0)))
            return 2.0 * self.inflight + depth - free
        return (2.0 * self.inflight
                + depth
                + float(snap.get("active_slots", 0)))

    def describe(self) -> Dict[str, Any]:
        return {
            "url": self.url,
            "up": self.up,
            "phase": self.phase,
            "draining": self.draining,
            "breaker": self.breaker.state(),
            "inflight": self.inflight,
            "score": self.score(),
            "load": dict(self.snapshot),
            "versions": dict(self.versions),
        }


class _Lease:
    """One dispatched request: holds the picked replica's in-flight
    slot until the response is fully relayed."""

    __slots__ = ("router", "replica", "conn", "resp", "stream", "status",
                 "headers", "body", "_closed")

    def __init__(self, router, replica, conn, resp, stream, status,
                 headers, body=None):
        self.router = router
        self.replica = replica
        self.conn = conn
        self.resp = resp
        self.stream = stream
        self.status = status
        self.headers = headers
        self.body = body
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.router._release(self.replica)
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass


class Router:
    """Load-aware request router over a set of ReplicaClients."""

    def __init__(
        self,
        replicas: Sequence[str] = (),
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        request_timeout_s: float = 120.0,
        breaker_kw: Optional[dict] = None,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        slo_policy: Optional[SLOPolicy] = None,
    ):
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.request_timeout_s = request_timeout_s
        # per-model SLO classes (fleetctl.tenancy): the router resolves
        # a request's class ONCE (model default, demotable by header/
        # body), scores the pick with it, and forwards it so the
        # replica's admission tiers agree with the pick
        self.slo_policy = slo_policy or SLOPolicy()
        self._breaker_kw = dict(breaker_kw or {})
        self._lock = threading.Lock()
        self._replicas: "collections.OrderedDict[str, ReplicaClient]" = (
            collections.OrderedDict())
        self._seq = 0
        self._next_name = 0
        self._prober: Optional[threading.Thread] = None
        self._probe_cond = threading.Condition()
        self._stopping = False
        self.registry = registry or obs_metrics.registry()
        # fleet counters: full pt_-prefixed names straight on the
        # unified registry (MetricSet would prepend ptserving_); the
        # labeled ones declare per replica in add_replica
        for name, help in (
            ("pt_router_requests_total",
             "requests accepted by the router front-end"),
            ("pt_router_retried_total",
             "dispatch attempts retried on another replica after a "
             "shed/503 response"),
            ("pt_router_unroutable_total",
             "requests that found no admittable replica (client saw a "
             "retryable 503)"),
        ):
            self.registry.declare_counter(name, help=help)
        self.registry.add_collector(self._fleet_families)
        for url in replicas:
            self.add_replica(url)

    # -- fleet membership ----------------------------------------------
    def _add_locked(self, url: str, name: Optional[str],
                    process: Optional["ReplicaProcess"],
                    breaker: Optional[CircuitBreaker],
                    phase: Optional[str] = None) -> ReplicaClient:
        """Create + register one client. Caller holds self._lock."""
        if name is None:
            name = f"r{self._next_name}"
        self._next_name += 1
        if name in self._replicas:
            raise ValueError(f"replica {name!r} already registered")
        if breaker is None and self._breaker_kw:
            breaker = CircuitBreaker(**self._breaker_kw)
        r = ReplicaClient(name, url, process=process, breaker=breaker,
                          phase=phase)
        self._replicas[name] = r
        return r

    def _declare_replica_counters(self, name: str) -> None:
        # per-replica counters declare at registration so the scrape
        # surface is complete before the first request routes
        for cname, chelp in (
            ("pt_router_routed_total",
             "requests dispatched to this replica"),
            ("pt_router_failed_over_total",
             "dispatches abandoned on this replica after a transport "
             "error (failed over to another)"),
        ):
            self.registry.declare_counter(cname, help=chelp,
                                          labels={"replica": name})

    def add_replica(self, url: str, name: Optional[str] = None,
                    process: Optional["ReplicaProcess"] = None,
                    breaker: Optional[CircuitBreaker] = None,
                    phase: Optional[str] = None
                    ) -> ReplicaClient:
        with self._lock:
            r = self._add_locked(url, name, process, breaker, phase)
        self._declare_replica_counters(r.name)
        self._probe_now()
        return r

    def remove_replica(self, name: str,
                       retire_series: bool = False
                       ) -> Optional[ReplicaClient]:
        """Drop one replica from the rotation. `retire_series=True` —
        the DELIBERATE retirement path (scale-down, rollout drain) —
        also removes the replica's labeled counter series from the
        registry so a scaled-down fleet doesn't accumulate dead
        `pt_router_*{replica=}` series (the `pt_replica_*` gauges are
        collector-rendered from live membership, so they drop with the
        client). FAILURE removal keeps the series: a SIGKILLed
        replica's routed/failed-over history is evidence (test_fleet
        pins this)."""
        with self._lock:
            r = self._replicas.pop(name, None)
        if r is not None and retire_series:
            for cname in ("pt_router_routed_total",
                          "pt_router_failed_over_total"):
                self.registry.remove_series(cname,
                                            labels={"replica": name})
        return r

    def set_draining(self, name: str, draining: bool = True) -> bool:
        """Mark a replica as retiring: it finishes what it has but
        pick() never selects it again. Returns False for unknown
        names."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return False
            r.draining = draining
            return True

    def flip(self, add: Sequence[Tuple[str, Optional["ReplicaProcess"]]],
             drain: Sequence[str]) -> List[ReplicaClient]:
        """ATOMIC membership change — the rollout's cutover point:
        under one lock acquisition the new replicas join the rotation
        and the old ones are marked draining, so there is no instant
        where a request can find neither version (zero-downtime
        contract; fleetctl/rollout.py drains + removes the old ones
        afterwards). Returns the clients added."""
        added: List[ReplicaClient] = []
        with self._lock:
            for name in drain:
                r = self._replicas.get(name)
                if r is not None:
                    r.draining = True
            for url, process in add:
                added.append(self._add_locked(url, None, process, None))
        for r in added:
            self._declare_replica_counters(r.name)
        self._probe_now()
        return added

    def replicas(self) -> List[ReplicaClient]:
        with self._lock:
            return list(self._replicas.values())

    # -- the pick hot path (NO blocking I/O — AST-linted) ---------------
    def pick(self, exclude: Sequence[str] = (),
             slo: Optional[str] = None,
             phase: Optional[str] = None) -> Optional[ReplicaClient]:
        """Join-shortest-queue over admitted replicas: lowest score()
        wins, ties go to the least-recently-picked (round-robin under
        uniform load instead of herding onto one replica). With `slo`
        given, replicas are scored by that class's own queue depth
        (per-class JSQ — batch backlog doesn't repel interactive
        traffic). With `phase` given, only replicas of that disagg
        class compete (each class scores on its own signal — see
        ReplicaClient.score). Draining replicas (rollout/scale-down)
        are never picked. Reads ONLY router-local state — breaker
        admission, in-flight counters and the probe loop's cached
        snapshots; never the network."""
        with self._lock:
            # scan with would_admit() (non-consuming) so a HALF_OPEN
            # replica that loses the JSQ comparison keeps its probe
            # budget; only the winner pays admit()
            ranked = sorted(
                ((r.score(slo), r.last_picked, r)
                 for r in self._replicas.values()
                 if r.name not in exclude and not r.draining
                 and (phase is None or r.phase == phase)
                 and r.breaker.would_admit()),
                key=lambda t: t[:2])
            for _, _, best in ranked:
                if not best.breaker.admit():
                    continue  # raced OPEN since the scan; next-best
                self._seq += 1
                best.last_picked = self._seq
                best.inflight += 1
                return best
        return None

    def _release(self, replica: ReplicaClient) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)

    # -- dispatch -------------------------------------------------------
    def dispatch(self, path: str, body: bytes,
                 request_id: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None,
                 slo: Optional[str] = None,
                 phase: Optional[str] = None,
                 exclude: Sequence[str] = ()) -> _Lease:
        """POST `body` to the best replica; returns a _Lease whose
        response is either buffered (`lease.body`) or streaming
        (`lease.resp` — chunked NDJSON, relay then `close()`).

        `slo` drives the per-class pick and is forwarded in
        X-PT-SLO-Class so the replica's admission tiers agree with the
        score the pick used. `phase` restricts the pick to one disagg
        replica class; `exclude` pre-blacklists replica names (the
        disagg dispatcher's re-prefill avoids the replica whose
        payload just failed).

        Failover contract: a 503 (replica shed / its model breaker)
        and any transport error move on to the next-best replica the
        first attempt didn't use; transport errors additionally feed
        the replica's ROUTER-side breaker. Raises NoReplicaError when
        no admittable replica remains."""
        self.registry.counter_inc("pt_router_requests_total")
        if slo is not None:
            headers = dict(headers or {})
            headers[SLO_HEADER] = slo
        tried: List[str] = list(exclude)
        last_shed: Optional[_Lease] = None
        while True:
            replica = self.pick(exclude=tried, slo=slo, phase=phase)
            if replica is None:
                if last_shed is not None:
                    # every admitted replica shed: relay the final 503
                    # (it carries Retry-After) rather than inventing one
                    return last_shed
                self.registry.counter_inc("pt_router_unroutable_total")
                raise NoReplicaError(
                    f"no replica available for {path} "
                    f"(tried {tried or 'none'}); retry later")
            tried.append(replica.name)
            if last_shed is not None:
                last_shed.close()
                last_shed = None
            try:
                lease = self._attempt(replica, path, body, request_id,
                                      headers)
            except (OSError, http.client.HTTPException) as e:
                # transport failure: the replica is gone or wedged —
                # feed its breaker and fail the request over
                self._release(replica)
                replica.breaker.record_failure()
                self.registry.counter_inc(
                    "pt_router_failed_over_total",
                    labels={"replica": replica.name})
                if obs_trace._armed:
                    obs_trace.instant(
                        "router.failover", cat="router",
                        replica=replica.name, request_id=request_id,
                        error=f"{type(e).__name__}: {e}")
                continue
            replica.breaker.record_success()
            if lease.status == 503:
                # shed / model-circuit-open: replica alive but refusing
                # — retry elsewhere, keep the last 503 as the fallback
                self.registry.counter_inc("pt_router_retried_total")
                last_shed = lease
                continue
            self.registry.counter_inc("pt_router_routed_total",
                                      labels={"replica": replica.name})
            return lease

    def _attempt(self, replica: ReplicaClient, path: str, body: bytes,
                 request_id: Optional[str],
                 headers: Optional[Dict[str, str]]) -> _Lease:
        """One POST to one replica. Raises OSError/HTTPException on
        transport failure (caller fails over); returns a _Lease
        otherwise. The replica's in-flight slot is already held by
        pick() and travels with the lease."""
        conn = http.client.HTTPConnection(
            replica.host, replica.port, timeout=self.request_timeout_s)
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        if request_id:
            hdrs[REQUEST_ID_HEADER] = request_id
        try:
            conn.request("POST", path, body=body, headers=hdrs)
            resp = conn.getresponse()
            ctype = resp.getheader("Content-Type", "")
            stream = "ndjson" in ctype
            resp_headers = [
                (k, v) for k, v in resp.getheaders()
                if k.lower() in ("content-type", "retry-after",
                                 REQUEST_ID_HEADER.lower())
            ]
            if stream:
                return _Lease(self, replica, conn, resp, True,
                              resp.status, resp_headers)
            payload = resp.read()  # short read raises → failover
        except BaseException:
            conn.close()
            raise
        conn.close()
        return _Lease(self, replica, None, None, False, resp.status,
                      resp_headers, body=payload)

    # -- health probing -------------------------------------------------
    def start(self) -> "Router":
        with self._probe_cond:
            if self._prober is not None and self._prober.is_alive():
                return self
            self._stopping = False
            self._prober = threading.Thread(
                target=self._probe_loop, name="ptrouter-probe",
                daemon=True)
            self._prober.start()
        return self

    def close(self) -> None:
        with self._probe_cond:
            self._stopping = True
            self._probe_cond.notify_all()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
        self.registry.remove_collector(self._fleet_families)

    def _probe_now(self) -> None:
        """Wake the probe loop (a just-added replica should be scored
        from a fresh snapshot, not a zero one)."""
        with self._probe_cond:
            self._probe_cond.notify_all()

    def _probe_loop(self) -> None:
        while True:
            with self._probe_cond:
                if self._stopping:
                    return
            for r in self.replicas():
                self.probe_one(r)
            with self._probe_cond:
                if self._stopping:
                    return
                self._probe_cond.wait(timeout=self.probe_interval_s)

    def probe_one(self, replica: ReplicaClient) -> bool:
        """One /healthz round-trip: refresh the replica's load snapshot
        and feed its breaker — a success while HALF_OPEN closes the
        circuit (re-admission after recovery/restart needs no traffic),
        a failure counts toward tripping it."""
        try:
            with urllib.request.urlopen(
                    replica.url + "/healthz",
                    timeout=self.probe_timeout_s) as f:
                payload = json.loads(f.read().decode())
        except Exception:
            replica.up = False
            replica.breaker.record_failure()
            return False
        replica.up = payload.get("status") in ("ok", "degraded")
        replica.snapshot = payload.get("load") or {}
        replica.versions = payload.get("versions") or {}
        replica.last_probe_s = time.monotonic()
        if replica.up and replica.breaker.state() != "closed":
            # the half-open probe budget is spent on a HEALTH CHECK,
            # not a user request: record the success to close it
            replica.breaker.admit()
            replica.breaker.record_success()
        return replica.up

    # -- introspection / metrics ---------------------------------------
    def health(self) -> Dict[str, Any]:
        reps = {r.name: r.describe() for r in self.replicas()}
        n_up = sum(1 for d in reps.values()
                   if d["up"] and d["breaker"] == "closed")
        status = ("ok" if n_up == len(reps) and reps else
                  "degraded" if n_up else "down")
        return {"status": status, "replicas": reps}

    def stats(self) -> Dict[str, Any]:
        reg = self.registry
        return {
            "replicas": {r.name: r.describe() for r in self.replicas()},
            "requests_total": reg.counter_value(
                "pt_router_requests_total"),
            "retried_total": reg.counter_value("pt_router_retried_total"),
            "unroutable_total": reg.counter_value(
                "pt_router_unroutable_total"),
            "routed": {
                r.name: reg.counter_value(
                    "pt_router_routed_total", labels={"replica": r.name})
                for r in self.replicas()
            },
            "failed_over": {
                r.name: reg.counter_value(
                    "pt_router_failed_over_total",
                    labels={"replica": r.name})
                for r in self.replicas()
            },
        }

    def _fleet_families(self):
        """Render-time collector: per-replica gauges in the unified
        registry, so one /metrics scrape on the router reports fleet
        state)."""
        reps = self.replicas()
        if not reps:
            return []
        up, state, queue, slots, inflight, draining = ([], [], [], [],
                                                       [], [])
        for r in reps:
            lb = {"replica": r.name}
            up.append((lb, 1.0 if r.up else 0.0))
            state.append((lb, float(STATE_CODES[r.breaker.state()])))
            queue.append((lb, float(r.snapshot.get("queue_depth", 0))))
            slots.append((lb, float(r.snapshot.get("active_slots", 0))))
            inflight.append((lb, float(r.inflight)))
            draining.append((lb, 1.0 if r.draining else 0.0))
        fams = [
            ("pt_replica_up", "gauge",
             "1 while the replica's last health probe succeeded", up),
            ("pt_replica_breaker_state", "gauge",
             "router-side replica circuit state "
             "(0=closed 1=half_open 2=open)", state),
            ("pt_replica_queue_depth", "gauge",
             "admission-queue depth last reported by the replica",
             queue),
            ("pt_replica_active_slots", "gauge",
             "active decode slots last reported by the replica", slots),
            ("pt_replica_inflight", "gauge",
             "router-tracked requests in flight on the replica",
             inflight),
            ("pt_replica_draining", "gauge",
             "1 while the replica is retiring (rollout/scale-down): "
             "finishing in-flight work, excluded from picks", draining),
        ]
        # disagg: per-phase breakdown of the same signals, one series
        # per replica CLASS ({phase=prefill|decode}) so dashboards see
        # the two classes' load separately without relabeling the
        # per-replica families above
        agg: Dict[str, Dict[str, float]] = {}
        for r in reps:
            if r.phase is None:
                continue
            a = agg.setdefault(r.phase, {"queue_depth": 0.0,
                                         "inflight": 0.0,
                                         "free_slots": 0.0,
                                         "replicas": 0.0})
            a["replicas"] += 1.0
            a["queue_depth"] += float(r.snapshot.get("queue_depth", 0))
            a["inflight"] += float(r.inflight)
            a["free_slots"] += max(
                0.0, float(r.snapshot.get("max_slots", 0))
                - float(r.snapshot.get("active_slots", 0)))
        if agg:
            def _series(key):
                return [({"phase": p}, v[key])
                        for p, v in sorted(agg.items())]
            fams.extend([
                ("pt_phase_replicas", "gauge",
                 "replicas registered in this disagg phase class",
                 _series("replicas")),
                ("pt_phase_queue_depth", "gauge",
                 "admission-queue depth summed over one phase class",
                 _series("queue_depth")),
                ("pt_phase_inflight", "gauge",
                 "router-tracked in-flight requests summed over one "
                 "phase class", _series("inflight")),
                ("pt_phase_free_slots", "gauge",
                 "free decode slots summed over one phase class "
                 "(prefill replicas report 0)", _series("free_slots")),
            ])
        return fams


# -- HTTP front-end ----------------------------------------------------------


class _RouterHandler(BaseHTTPRequestHandler):
    server: "RouterServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload, content_type="application/json",
              extra_headers=()):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str):
        self._send(code, {"error": message},
                   extra_headers=(
                       (("Retry-After", "1"),) if code == 503 else ()))

    def do_GET(self):
        router = self.server.router
        if self.path == "/healthz":
            h = router.health()
            self._send(200, h)
        elif self.path == "/stats":
            self._send(200, router.stats())
        elif self.path == "/metrics":
            self._send(200, router.registry.render().encode(),
                       content_type="text/plain; version=0.0.4")
        elif self.path == "/admin/fleet":
            self._send(200, self.server.admin_fleet())
        else:
            self._error(404, f"no route {self.path!r}")

    def do_POST(self):
        if self.path == "/admin/rollout":
            self._admin_rollout()
            return
        if not (self.path.startswith("/predict")
                or self.path.startswith("/generate")):
            self._error(404, f"no route {self.path!r}")
            return
        router = self.server.router
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        # mint-or-forward: the correlation id crosses the router hop in
        # this header; the replica adopts it (server._request_id)
        rid = (self.headers.get(REQUEST_ID_HEADER)
               or obs_trace.new_request_id("rt"))
        try:
            slo = self._resolve_slo(body)
        except ValueError as e:
            self._error(400, f"bad request: {e}")
            return
        # disagg topology: /generate requests phase-split through the
        # dispatcher (prefill pick → payload ship → pinned decode pick);
        # /predict and everything else keep the monolithic path
        disagg = getattr(self.server, "disagg", None)
        try:
            with obs_trace.span("http.route", cat="router",
                                path=self.path, request_id=rid,
                                slo=slo):
                if disagg is not None and self.path.startswith(
                        "/generate"):
                    lease = disagg.generate(self.path, body,
                                            request_id=rid, slo=slo)
                else:
                    lease = router.dispatch(self.path, body,
                                            request_id=rid, slo=slo)
        except NoReplicaError as e:
            self._error(503, str(e))
            return
        try:
            if lease.stream:
                self._relay_stream(lease, rid)
            else:
                extra = list(lease.headers)
                if not any(k.lower() == REQUEST_ID_HEADER.lower()
                           for k, _ in extra):
                    extra.append((REQUEST_ID_HEADER, rid))
                ctype = dict((k.lower(), v) for k, v in lease.headers).get(
                    "content-type", "application/json")
                self._send(lease.status, lease.body, content_type=ctype,
                           extra_headers=[
                               (k, v) for k, v in extra
                               if k.lower() != "content-type"])
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; replica finishes server-side
        finally:
            lease.close()

    def _resolve_slo(self, body: bytes) -> str:
        """The request's SLO class, resolved ONCE at the router: the
        model's class (from the path) is the default; the request may
        demote itself via X-PT-SLO-Class or the body "slo" field.
        Raises ValueError on an unknown class name (400)."""
        model = "default"
        for route in ("/predict/", "/generate/"):
            if self.path.startswith(route):
                model = self.path[len(route):]
                break
        requested = self.headers.get(SLO_HEADER)
        if not requested and b'"slo"' in body:
            try:
                requested = json.loads(body).get("slo")
            except (ValueError, AttributeError):
                requested = None
        return resolve_class(
            self.server.router.slo_policy.class_of(model), requested)

    def _admin_rollout(self) -> None:
        """POST /admin/rollout {"model_dir": ..., "model": opt}: run a
        zero-downtime rollout of the artifact at model_dir through the
        attached fleet (cli `paddle_tpu_torch fleetctl rollout` calls this).
        Blocking — the reply is the rollout report."""
        fleet = self.server.fleet
        if fleet is None:
            self._error(501, "no fleet attached to this router "
                             "(serve --replicas builds one)")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            model_dir = req["model_dir"]
        except (ValueError, KeyError, TypeError) as e:
            self._error(400, f"bad request: {e}")
            return
        from ..fleetctl.rollout import RolloutError, RolloutManager

        try:
            report = RolloutManager(fleet).rollout(
                model_dir, model=req.get("model", "default"))
        except RolloutError as e:
            self._error(409, str(e))
            return
        except Exception as e:
            self._error(500, f"{type(e).__name__}: {e}")
            return
        self._send(200, report)

    def _relay_stream(self, lease: _Lease, rid: str) -> None:
        """Chunked NDJSON pass-through, one line per chunk. A replica
        dying MID-STREAM cannot be failed over (the client already has
        bytes): emit a terminal retryable {"event": "error"} line and
        feed the replica's breaker."""
        self.send_response(lease.status)
        ctype = dict((k.lower(), v) for k, v in lease.headers).get(
            "content-type", "application/x-ndjson")
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header(REQUEST_ID_HEADER, rid)
        self.end_headers()
        replica = lease.replica
        try:
            while True:
                try:
                    line = lease.resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    replica.breaker.record_failure()
                    self.server.router.registry.counter_inc(
                        "pt_router_failed_over_total",
                        labels={"replica": replica.name})
                    err = json.dumps({
                        "event": "error",
                        "error": f"replica {replica.name} lost "
                                 f"mid-stream ({type(e).__name__}); "
                                 "retry the request",
                        "kind": "ReplicaLostError",
                        "retryable": True,
                    })
                    self._write_chunk(err.encode() + b"\n")
                    break
                if not line:
                    break
                self._write_chunk(line)
            self._write_chunk(b"")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()


class RouterServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, router: Router,
                 fleet: Optional["Fleet"] = None,
                 autoscaler=None, disagg=None):
        super().__init__(addr, _RouterHandler)
        self.router = router
        # control-plane attachments (cli _serve_fleet wires these): the
        # fleet enables /admin/rollout; the autoscaler reports through
        # /admin/fleet; a DisaggDispatcher phase-splits /generate
        self.fleet = fleet
        self.autoscaler = autoscaler
        self.disagg = disagg

    def admin_fleet(self) -> Dict[str, Any]:
        """GET /admin/fleet: one control-plane status document —
        router health, fleet size/warm-pool state, autoscaler stats."""
        out: Dict[str, Any] = {"router": self.router.health()}
        if self.fleet is not None:
            out["fleet"] = self.fleet.describe()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        return out

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        self.router.start()
        t = threading.Thread(target=self.serve_forever,
                             name="ptrouter-http", daemon=True)
        t.start()
        return t


def make_router_server(router: Router, host: str = "127.0.0.1",
                       port: int = 0, fleet: Optional["Fleet"] = None,
                       autoscaler=None, disagg=None) -> RouterServer:
    """Bind (port 0 = OS-assigned; read `server.port`)."""
    return RouterServer((host, port), router, fleet=fleet,
                        autoscaler=autoscaler, disagg=disagg)


# -- replica processes + warm pool -------------------------------------------

_URL_RE = re.compile(r"serving .* on (http://[\w.\-]+:\d+)")


class ReplicaProcess:
    """One `python -m paddle_tpu_torch serve` subprocess. The replica binds
    port 0 and prints its URL; `wait_ready()` parses it from stdout and
    then blocks until /healthz answers, so a 'ready' replica is warmed
    and immediately routable. With `log_path` every line it prints is
    also appended to that file."""

    def __init__(self, model_args: Sequence[str], host: str = "127.0.0.1",
                 extra_args: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 name: Optional[str] = None,
                 log_path: Optional[str] = None):
        self.name = name
        self.log_path = log_path
        argv = [sys.executable, "-m", "paddle_tpu_torch", "serve",
                *model_args, "--host", host, "--port", "0", *extra_args]
        self.argv = argv
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True)
        self.url: Optional[str] = None
        self._lines: "collections.deque[str]" = collections.deque(
            maxlen=200)
        self._url_event = threading.Event()
        self._drain = threading.Thread(target=self._drain_stdout,
                                       daemon=True)
        self._drain.start()

    def _drain_stdout(self) -> None:
        # the pipe must keep draining for the replica's whole life or a
        # chatty child blocks on a full pipe; keep a ring of lines for
        # failure diagnosis
        log = open(self.log_path, "a") if self.log_path else None
        for line in self.proc.stdout:
            self._lines.append(line.rstrip("\n"))
            if log is not None:
                log.write(line)
                log.flush()
            if self.url is None:
                m = _URL_RE.search(line)
                if m:
                    self.url = m.group(1)
                    self._url_event.set()
        if log is not None:
            log.close()
        self._url_event.set()  # EOF: wake waiters (spawn failed)

    def wait_ready(self, timeout: float = 120.0) -> str:
        """Block until the replica printed its URL and /healthz
        answers. Raises RuntimeError (with the captured output tail) if
        the process died or the timeout passed first."""
        deadline = time.monotonic() + timeout
        self._url_event.wait(timeout=timeout)
        if self.url is None:
            raise RuntimeError(
                f"replica {self.name or self.argv} did not report a URL "
                f"(exit={self.proc.poll()}):\n" + "\n".join(self._lines))
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.name or self.url} exited "
                    f"{self.proc.returncode} before ready:\n"
                    + "\n".join(self._lines))
            try:
                with urllib.request.urlopen(self.url + "/healthz",
                                            timeout=2.0) as f:
                    if f.status == 200:
                        return self.url
            except Exception:
                time.sleep(0.05)
        raise RuntimeError(f"replica {self.name or self.url} not "
                           f"healthy within {timeout}s")

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        """SIGKILL — the chaos-test death: no drain, no goodbye."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)

    def terminate(self) -> None:
        """SIGTERM — the graceful death: the replica drains in-flight
        generation streams before exiting (cli serve's handler)."""
        if self.proc.poll() is None:
            self.proc.terminate()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def output_tail(self, n: int = 40) -> str:
        return "\n".join(list(self._lines)[-n:])


class WarmPool:
    """Pre-forked standby replicas. `spawn_fn()` returns a
    ReplicaProcess; the filler thread keeps `standby` of them spawned,
    warmed, and /healthz-ready so `take()` is promotion, not a cold
    start — the warm-pool half of the traffic-spike/failover story."""

    def __init__(self, spawn_fn, standby: int = 1,
                 ready_timeout_s: float = 180.0):
        self.spawn_fn = spawn_fn
        self.standby = standby
        self.ready_timeout_s = ready_timeout_s
        self._cond = threading.Condition()
        self._ready: List[ReplicaProcess] = []
        self._stopping = False
        self._filler: Optional[threading.Thread] = None
        self.spawned_total = 0
        self.spawn_failures = 0

    def start(self) -> "WarmPool":
        with self._cond:
            if self._filler is not None and self._filler.is_alive():
                return self
            self._stopping = False
            self._filler = threading.Thread(
                target=self._fill_loop, name="ptrouter-warmpool",
                daemon=True)
            self._filler.start()
        return self

    def _fill_loop(self) -> None:
        while True:
            with self._cond:
                if self._stopping:
                    return
                # drop standbys that died while parked
                self._ready = [p for p in self._ready
                               if p.poll() is None]
                need = self.standby - len(self._ready)
                if need <= 0:
                    self._cond.wait(timeout=0.25)
                    continue
            try:
                p = self.spawn_fn()
                p.wait_ready(timeout=self.ready_timeout_s)
            except Exception:
                self.spawn_failures += 1
                time.sleep(0.5)  # don't hot-loop a broken spawner
                continue
            with self._cond:
                if self._stopping:
                    p.kill()
                    return
                self._ready.append(p)
                self.spawned_total += 1
                self._cond.notify_all()

    def ready_count(self) -> int:
        with self._cond:
            return len(self._ready)

    def take(self, timeout: float = 0.0) -> Optional[ReplicaProcess]:
        """A ready standby (None if none within `timeout`); taking one
        wakes the filler to spawn its replacement."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                self._ready = [p for p in self._ready if p.poll() is None]
                if self._ready:
                    p = self._ready.pop(0)
                    self._cond.notify_all()
                    return p
                rest = deadline - time.monotonic()
                if rest <= 0 or self._stopping:
                    return None
                self._cond.wait(timeout=rest)

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            parked = list(self._ready)
            self._ready.clear()
            self._cond.notify_all()
        for p in parked:
            p.kill()
        if self._filler is not None:
            self._filler.join(timeout=5.0)


class Fleet:
    """N managed replicas behind one Router, with warm-pool
    replacement: a supervisor loop notices a dead replica process,
    trips its router breaker (no threshold wait — the process table IS
    proof), removes it, and promotes a warmed standby. `cli serve
    --replicas N [--standby K]` builds one of these."""

    def __init__(self, spawn_fn, replicas: int = 2, standby: int = 0,
                 router: Optional[Router] = None,
                 supervise_interval_s: float = 0.25,
                 ready_timeout_s: float = 180.0):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.spawn_fn = spawn_fn
        self.n_replicas = replicas
        self.ready_timeout_s = ready_timeout_s
        self.supervise_interval_s = supervise_interval_s
        self.router = router or Router()
        self.warm = WarmPool(spawn_fn, standby=standby,
                             ready_timeout_s=ready_timeout_s) \
            if standby > 0 else None
        self._procs: Dict[str, ReplicaProcess] = {}
        # deliberately-retiring replicas: moved OUT of _procs (so the
        # supervisor never mistakes the coming exit for a death and
        # promotes a standby against the scale-down) and held here
        # until drained + reaped
        self._retiring: Dict[str, ReplicaProcess] = {}
        self._scale_lock = threading.Lock()
        self._super: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self.replaced_total = 0
        self.retired_total = 0
        # rollout hook (cli _serve_fleet sets this): model_dir → a
        # spawn_fn producing replicas that serve THAT artifact with
        # this fleet's serve flags; fleetctl/rollout.py uses it to warm
        # the new version and to repoint standby respawns after a flip
        self.spawn_template = None

    def start(self) -> "Fleet":
        # spawn the whole rotation CONCURRENTLY (model load + warmup
        # dominate), then register each as it turns ready
        procs = [self.spawn_fn() for _ in range(self.n_replicas)]
        for p in procs:
            p.wait_ready(timeout=self.ready_timeout_s)
            self._register(p)
        if self.warm is not None:
            self.warm.start()
        self.router.start()
        self._stop_event.clear()
        self._super = threading.Thread(target=self._supervise,
                                       name="ptrouter-fleet",
                                       daemon=True)
        self._super.start()
        return self

    def _register(self, p: ReplicaProcess) -> ReplicaClient:
        r = self.router.add_replica(p.url, process=p)
        p.name = r.name
        self._procs[r.name] = p
        return r

    def _supervise(self) -> None:
        while not self._stop_event.wait(self.supervise_interval_s):
            for name, p in list(self._procs.items()):
                if p.poll() is None:
                    continue
                # process is DEAD: trip + remove, then promote a warm
                # standby if one is ready (never block the supervisor
                # on a spawn — the filler replaces in the background)
                dead = self.router.remove_replica(name)
                if dead is not None:
                    dead.breaker.trip()
                self._procs.pop(name, None)
                if self.warm is not None:
                    repl = self.warm.take(timeout=0.0)
                    if repl is not None:
                        self._register(repl)
                        self.replaced_total += 1

    # -- elastic capacity (the autoscaler's actuators) ------------------
    def size(self) -> int:
        return len(self._procs)

    def describe(self) -> Dict[str, Any]:
        return {
            "replicas": len(self._procs),
            "retiring": sorted(self._retiring),
            "warm_ready": (self.warm.ready_count()
                           if self.warm is not None else 0),
            "standby": (self.warm.standby
                        if self.warm is not None else 0),
            "replaced_total": self.replaced_total,
            "retired_total": self.retired_total,
        }

    def scale_up(self, n: int = 1) -> List[str]:
        """Promote up to `n` warm standbys into the rotation. NON-
        blocking: only already-/healthz-ready standbys are taken (the
        warm pool's filler replaces them in the background), so an
        autoscaler tick never waits out a cold model load. Returns the
        names registered."""
        names: List[str] = []
        if self.warm is None:
            return names
        with self._scale_lock:
            for _ in range(n):
                p = self.warm.take(timeout=0.0)
                if p is None:
                    break
                names.append(self._register(p).name)
        return names

    def scale_down(self, n: int = 1,
                   drain_timeout_s: float = 30.0) -> List[str]:
        """Retire the `n` least-loaded replicas: mark them draining
        (immediately invisible to pick()), then drain + remove +
        SIGTERM in a background thread — the caller (an autoscaler
        tick) never blocks on the drain. At least one replica always
        survives. Returns the names being retired."""
        with self._scale_lock:
            candidates = [
                r for r in self.router.replicas()
                if not r.draining and r.name in self._procs
            ]
            candidates.sort(key=lambda r: r.score())
            n = min(n, len(self._procs) - 1)
            victims = [r.name for r in candidates[:max(0, n)]]
            for name in victims:
                self.router.set_draining(name)
                self._retiring[name] = self._procs.pop(name)
        if victims:
            threading.Thread(
                target=self._drain_and_retire,
                args=(victims, drain_timeout_s),
                name="ptrouter-retire", daemon=True).start()
        return victims

    def retire(self, names: Sequence[str],
               drain_timeout_s: float = 30.0) -> None:
        """Synchronously drain + remove + terminate the named replicas
        (the rollout's old-version drain). The names must already be
        draining (router.flip / set_draining) — this moves their
        processes out of supervision and reaps them."""
        with self._scale_lock:
            for name in names:
                if name in self._procs:
                    self.router.set_draining(name)
                    self._retiring[name] = self._procs.pop(name)
        self._drain_and_retire(list(names), drain_timeout_s)

    def _drain_and_retire(self, names: Sequence[str],
                          drain_timeout_s: float) -> None:
        """Wait (bounded) until each named replica reports an empty
        queue and has no router-tracked in-flight work, then remove it
        WITH series retirement and terminate its process. In-flight
        streams run to 'done' — SIGTERM only lands after the router
        sees zero in-flight, and cli serve's handler drains anyway."""
        deadline = time.monotonic() + drain_timeout_s
        clients = {r.name: r for r in self.router.replicas()}
        for name in names:
            r = clients.get(name)
            while r is not None and time.monotonic() < deadline:
                if (r.inflight == 0
                        and not r.snapshot.get("queue_depth", 0)):
                    break
                time.sleep(0.02)
            self.router.remove_replica(name, retire_series=True)
            p = self._retiring.pop(name, None)
            if p is not None:
                p.terminate()
                if p.wait(timeout=max(5.0,
                                      deadline - time.monotonic())) \
                        is None:
                    p.kill()
            self.retired_total += 1

    def set_spawn_fn(self, spawn_fn) -> None:
        """Repoint replica creation (rollout cutover): future warm-pool
        standbys and supervisor replacements spawn the NEW version."""
        self.spawn_fn = spawn_fn
        if self.warm is not None:
            self.warm.spawn_fn = spawn_fn

    def adopt(self, p: ReplicaProcess) -> ReplicaClient:
        """Register an externally spawned, already-ready replica into
        the rotation + supervision (rollout warms new-version replicas
        before the router ever sees them)."""
        return self._register(p)

    def stop(self, graceful: bool = False) -> None:
        self._stop_event.set()
        if self._super is not None:
            self._super.join(timeout=5.0)
        if self.warm is not None:
            self.warm.stop()
        self.router.close()
        procs = list(self._procs.values()) + list(self._retiring.values())
        for p in procs:
            (p.terminate if graceful else p.kill)()
        for p in procs:
            if p.wait(timeout=30.0 if graceful else 10.0) is None:
                p.kill()
        self._procs.clear()
        self._retiring.clear()


def replica_spawner(model_args: Sequence[str], host: str = "127.0.0.1",
                    extra_args: Sequence[str] = (),
                    env: Optional[Dict[str, str]] = None,
                    log_dir: Optional[str] = None):
    """A spawn_fn for Fleet/WarmPool over `cli serve` argv fragments
    (e.g. model_args=["--model_dir", d]). The child inherits (a copy
    of) this process's environment unless `env` overrides it. With
    `log_dir` each replica's output also goes to `replica-<n>.log`
    there, numbered in spawn order."""
    base_env = dict(os.environ if env is None else env)
    numbers = itertools.count(1)

    def spawn() -> ReplicaProcess:
        log_path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            log_path = os.path.join(log_dir, f"replica-{next(numbers)}.log")
        return ReplicaProcess(model_args, host=host,
                              extra_args=extra_args, env=base_env,
                              log_path=log_path)

    return spawn
