"""Simulated replicas: the replica wire protocol without the model
(paddle_tpu/fleetctl/sim.py).

Control-plane behavior — JSQ picks, SLO-tier shedding, autoscaler
reactions, rollout flips — depends on the protocol between router and
replica (/healthz load block, /predict, /generate NDJSON, shed 503s),
not on what computes inside the replica. `SimReplica` is that
protocol over a configurable service-time model, in-process:

- the REAL `AdmissionQueue` (serving/batcher.py) fronts a pool of
  `slots` worker threads, so the batch-first shed order and the
  queue-age signal a control-plane test exercises are the exact code
  production requests hit, not a re-implementation;
- per-request service time comes from the request body (`sim_ms`,
  `tokens`) — the trace harness (fleetctl/traces.py) draws these from
  a seeded distribution, so a replayed trace drives bit-identical
  work through the sim fleet;
- the process-facing API (`url`, `name`, `wait_ready`, `poll`,
  `kill`, `terminate`, `wait`, `output_tail`) matches ReplicaProcess,
  so Fleet / WarmPool / Router / Autoscaler / RolloutManager run
  UNCHANGED over sim replicas — what the fleet_autoscale bench and
  the rollout-under-load test need, at zero subprocess/model cost.

Each SimReplica keeps a PRIVATE MetricsRegistry: a bench spins up
dozens across scenarios, and their shed/admit counters must not
accumulate into the process-global scrape.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..serving.batcher import AdmissionQueue, ShedError
from ..serving.metrics import MetricSet
from ..serving.server import REQUEST_ID_HEADER
from .tenancy import INTERACTIVE, SLO_HEADER, resolve_class

__all__ = ["SimReplica"]

_ids = itertools.count()


class _SimRequest:
    """One queued unit of simulated work (AdmissionQueue item)."""

    __slots__ = ("slo_class", "deadline", "enqueued_at", "service_s",
                 "prefill_s", "tokens", "events", "done", "error")

    def __init__(self, slo: str, service_s: float, tokens: int,
                 deadline: float, prefill_s: float = 0.0):
        self.slo_class = slo
        self.deadline = deadline
        self.enqueued_at = 0.0
        self.service_s = service_s
        self.prefill_s = prefill_s
        self.tokens = max(1, tokens)
        import queue as _queue

        self.events: "_queue.Queue[Tuple[str, Any]]" = _queue.Queue()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.events.put(("error", exc))
        self.done.set()


class SimReplica:
    """One simulated replica: HTTP server + slot workers over the real
    AdmissionQueue. `service_ms` is the default per-request service
    time (a request's body overrides it with "sim_ms")."""

    def __init__(self, service_ms: float = 5.0, slots: int = 4,
                 max_queue: int = 32,
                 fingerprint: str = "sim0000000000000",
                 models: Tuple[str, ...] = ("default",),
                 timeout_ms: float = 30000.0,
                 host: str = "127.0.0.1"):
        self.service_s = service_ms / 1e3
        self.slots = slots
        self.fingerprint = fingerprint
        self.models = tuple(models)
        self.timeout_s = timeout_ms / 1e3
        self.name: Optional[str] = None
        self.registry = obs_metrics.MetricsRegistry()
        self.metrics = MetricSet("ptserving", registry=self.registry)
        self._cond = threading.Condition()
        self.aq = AdmissionQueue(max_queue, self._cond, self.metrics,
                                 prefix="sim_")
        self._active = 0
        self._prefills_running = 0
        self._stopping = False
        self._exited = threading.Event()
        self.requests_total = 0
        # disagg phase counters (mirror ModelRegistry.load()): which
        # phase this sim actually served
        self.prefills_total = 0
        self.handoffs_admitted_total = 0
        sim = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, sim.healthz())
                elif self.path == "/metrics":
                    body = sim.registry.render().encode()
                    self._reply(200, body,
                                ctype="text/plain; version=0.0.4")
                else:
                    self._reply(404, {"error": f"no route {self.path!r}"})

            def do_POST(self):
                # disagg phase endpoints: the sim speaks the same
                # /prefill → opaque payload → /admit wire the real
                # replica does, so the REAL DisaggDispatcher + phased
                # Router drive sim fleets in the serving_disagg bench
                if self.path == "/prefill" \
                        or self.path.startswith("/prefill/"):
                    self._prefill()
                    return
                if self.path == "/admit" \
                        or self.path.startswith("/admit/"):
                    self._admit()
                    return
                if not (self.path.startswith("/predict")
                        or self.path.startswith("/generate")):
                    self._reply(404, {"error": f"no route {self.path!r}"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                rid = self.headers.get(REQUEST_ID_HEADER) or "sim-req"
                try:
                    slo = resolve_class(
                        INTERACTIVE,
                        self.headers.get(SLO_HEADER) or req.get("slo"))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                stream = (self.path.startswith("/generate")
                          and bool(req.get("stream")))
                service_s = float(req.get("sim_ms", sim.service_s * 1e3)
                                  ) / 1e3
                tokens = int(req.get("tokens", 1)) if stream else 1
                timeout_s = (float(req["timeout_ms"]) / 1e3
                             if "timeout_ms" in req else sim.timeout_s)
                # monolithic phase split: "sim_prefill_ms" makes the
                # request run an exclusive prefix before its tokens,
                # stalling the replica's other decode streams — the
                # same body a disagg topology splits across /prefill
                # and /admit instead
                sreq = _SimRequest(slo, service_s, tokens,
                                   time.monotonic() + timeout_s,
                                   prefill_s=float(
                                       req.get("sim_prefill_ms", 0.0)
                                   ) / 1e3)
                try:
                    sim.aq.put(sreq)
                except ShedError as e:
                    self._reply(503, {"error": str(e)},
                                retry_after=True)
                    return
                if stream:
                    self._stream(sreq, rid)
                    return
                sreq.done.wait(timeout=timeout_s + max(1.0, timeout_s))
                if sreq.error is not None:
                    code = 503 if isinstance(sreq.error, ShedError) \
                        else 504
                    self._reply(code, {"error": str(sreq.error)},
                                retry_after=(code == 503))
                    return
                self._reply(200, {
                    "model": "default",
                    "fingerprint": sim.fingerprint,
                    "outputs": {"y": [[0.0]]},
                }, rid=rid)

            def _prefill(self) -> None:
                """Prefill phase: sleep "sim_prefill_ms" in a slot
                (compute-bound prefix), then return an opaque handoff
                payload carrying the decode-side budget."""
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                rid = self.headers.get(REQUEST_ID_HEADER) or "sim-pf"
                try:
                    slo = resolve_class(
                        INTERACTIVE,
                        self.headers.get(SLO_HEADER) or req.get("slo"))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                service_s = float(
                    req.get("sim_prefill_ms",
                            req.get("sim_ms", sim.service_s * 1e3))) / 1e3
                timeout_s = (float(req["timeout_ms"]) / 1e3
                             if "timeout_ms" in req else sim.timeout_s)
                sreq = _SimRequest(slo, 0.0, 1,
                                   time.monotonic() + timeout_s,
                                   prefill_s=service_s)
                try:
                    sim.aq.put(sreq)
                except ShedError as e:
                    self._reply(503, {"error": str(e)}, retry_after=True)
                    return
                sreq.done.wait(timeout=timeout_s + max(1.0, timeout_s))
                if sreq.error is not None:
                    code = 503 if isinstance(sreq.error, ShedError) \
                        else 504
                    self._reply(code, {"error": str(sreq.error)},
                                retry_after=(code == 503))
                    return
                sim.prefills_total += 1
                payload = b"SIMHO" + json.dumps({
                    "decode_ms": float(
                        req.get("sim_decode_ms",
                                req.get("sim_ms", sim.service_s * 1e3))),
                    "tokens": int(req.get("tokens", 1)),
                    "fingerprint": sim.fingerprint,
                }, sort_keys=True).encode()
                self._reply(200, payload,
                            ctype="application/octet-stream", rid=rid)

            def _admit(self) -> None:
                """Decode phase: admit a shipped payload, run its
                decode budget through the slot pool (stream option in
                the query string — the body is opaque bytes)."""
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                opts = {k: v[-1]
                        for k, v in parse_qs(u.query).items()}
                length = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(length)
                rid = self.headers.get(REQUEST_ID_HEADER) or "sim-adm"
                if not payload.startswith(b"SIMHO"):
                    self._reply(400, {"error": "not a sim handoff "
                                               "payload (bad magic)"})
                    return
                try:
                    hdr = json.loads(payload[5:].decode())
                except ValueError as e:
                    self._reply(400, {"error": f"bad payload: {e}"})
                    return
                if hdr.get("fingerprint") != sim.fingerprint:
                    # mixed-version fleet: same 409 contract as the
                    # real replica's HandoffSchemaError
                    self._reply(409, {
                        "error": "handoff fingerprint "
                                 f"{hdr.get('fingerprint')} != this "
                                 f"replica's {sim.fingerprint}: roll "
                                 "the fleet to one artifact "
                                 "(paddle_tpu_torch fleetctl rollout)",
                        "kind": "HandoffSchemaError"})
                    return
                try:
                    slo = resolve_class(INTERACTIVE,
                                        self.headers.get(SLO_HEADER))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                stream = opts.get("stream") in ("1", "true")
                timeout_s = (float(opts["timeout_ms"]) / 1e3
                             if "timeout_ms" in opts else sim.timeout_s)
                tokens = int(hdr.get("tokens", 1))
                decode_s = float(hdr.get("decode_ms",
                                         sim.service_s * 1e3)) / 1e3
                sreq = _SimRequest(slo, decode_s, tokens,
                                   time.monotonic() + timeout_s)
                try:
                    sim.aq.put(sreq)
                except ShedError as e:
                    self._reply(503, {"error": str(e)}, retry_after=True)
                    return
                sim.handoffs_admitted_total += 1
                if stream:
                    self._stream(sreq, rid)
                    return
                sreq.done.wait(timeout=timeout_s + max(1.0, timeout_s))
                if sreq.error is not None:
                    code = 503 if isinstance(sreq.error, ShedError) \
                        else 504
                    self._reply(code, {"error": str(sreq.error)},
                                retry_after=(code == 503))
                    return
                self._reply(200, {
                    "model": "default",
                    "fingerprint": sim.fingerprint,
                    "outputs": {"ids": [[tokens]]},
                }, rid=rid)

            def _stream(self, sreq: "_SimRequest", rid: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header(REQUEST_ID_HEADER, rid)
                self.end_headers()
                try:
                    while True:
                        kind, payload = sreq.events.get(
                            timeout=sim.timeout_s)
                        if kind == "token":
                            line = {"event": "token", "row": 0,
                                    "step": payload, "token": payload}
                        elif kind == "done":
                            line = {"event": "done", "model": "default",
                                    "fingerprint": sim.fingerprint,
                                    "outputs": {"ids": [[payload]]}}
                        else:
                            line = {"event": "error",
                                    "error": str(payload),
                                    "kind": type(payload).__name__}
                        self._chunk(json.dumps(line).encode() + b"\n")
                        if kind in ("done", "error"):
                            break
                    self._chunk(b"")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(
                    f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def _reply(self, code, payload,
                       ctype="application/json", rid=None,
                       retry_after=False):
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if rid:
                    self.send_header(REQUEST_ID_HEADER, rid)
                if retry_after:
                    self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, 0), _Handler)
        self._httpd.daemon_threads = True
        self.url = f"http://{host}:{self._httpd.server_address[1]}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"sim-replica-{next(_ids)}", daemon=True)
        self._http_thread.start()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{self._http_thread.name}-w{i}")
            for i in range(slots)
        ]
        for w in self._workers:
            w.start()

    # -- the simulated decode pool --------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cond:
                req = None
                while req is None and not self._stopping:
                    req = self.aq.pop()
                    if req is None:
                        self._cond.wait(timeout=0.1)
                if req is None:
                    return
                self._active += 1
            try:
                if req.prefill_s > 0.0:
                    # prefix compute is EXCLUSIVE on the device: while
                    # it runs, every decode stream on this replica
                    # stalls (the real scheduler's pool step and the
                    # prefix program share the accelerator, so a fat
                    # prefill freezes token emission for the whole
                    # pool). A disagg decode replica never runs a
                    # prefill, so its cadence is never frozen — the
                    # head-of-line effect the serving_disagg bench
                    # measures.
                    with self._cond:
                        self._prefills_running += 1
                    try:
                        time.sleep(req.prefill_s)
                    finally:
                        with self._cond:
                            self._prefills_running -= 1
                            self._cond.notify_all()
                per_token = req.service_s / req.tokens
                for t in range(req.tokens):
                    if req.service_s > 0.0:
                        self._stall_for_prefill()
                    time.sleep(per_token)
                    req.events.put(("token", t))
                req.events.put(("done", req.tokens))
                req.done.set()
                self.requests_total += 1
            finally:
                with self._cond:
                    self._active -= 1

    def _stall_for_prefill(self) -> None:
        """Pause decode-token emission while any prefix program runs
        on this replica's device (see the worker comment)."""
        with self._cond:
            while self._prefills_running and not self._stopping:
                self._cond.wait(timeout=0.005)

    # -- wire surface ---------------------------------------------------
    def healthz(self) -> Dict[str, Any]:
        oldest = self.aq.oldest_enqueued()
        age_ms = (round((time.monotonic() - oldest) * 1e3, 3)
                  if oldest is not None else 0.0)
        depth = self.aq.depth()
        classes = self.aq.depth_by_class()
        load = {
            "queue_depth": depth,
            "queue_age_ms": age_ms,
            "active_slots": self._active,
            "max_slots": self.slots,
            "free_slots": max(0, self.slots - self._active),
            "slot_occupancy": self._active / self.slots,
            "first_token_p99_ms": 0.0,
            "dispatches_total": self.requests_total,
            "syncs_total": self.requests_total,
            "prefills_total": self.prefills_total,
            "handoffs_admitted_total": self.handoffs_admitted_total,
            "classes": classes,
            "models": {
                m: {"queue_depth": depth, "queue_age_ms": age_ms,
                    "classes": classes, "slo_class": INTERACTIVE}
                for m in self.models
            },
        }
        return {
            "status": "ok",
            "models": list(self.models),
            "circuits": {m: "closed" for m in self.models},
            "load": load,
            "versions": {m: self.fingerprint for m in self.models},
        }

    # -- ReplicaProcess-compatible API ----------------------------------
    def wait_ready(self, timeout: float = 120.0) -> str:
        return self.url  # the server binds in __init__

    def poll(self) -> Optional[int]:
        return 0 if self._exited.is_set() else None

    def kill(self) -> None:
        self._shutdown()

    def terminate(self) -> None:
        """Graceful: let queued + active work finish (bounded) before
        the server goes away — mirrors cli serve's SIGTERM drain."""
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with self._cond:
                if not self.aq.depth() and self._active == 0:
                    break
            time.sleep(0.01)
        self._shutdown()

    def _shutdown(self) -> None:
        if self._exited.is_set():
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self.aq.drain(ShedError("sim replica shutting down"))
        self._httpd.shutdown()
        self._httpd.server_close()
        self._exited.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return 0 if self._exited.wait(timeout=timeout or 0.0) else None

    def output_tail(self, n: int = 40) -> str:
        return f"<sim replica {self.name or self.url}>"
