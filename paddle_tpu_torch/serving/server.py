"""Threaded stdlib-HTTP JSON front end over the serving engines
(paddle_tpu/serving/server.py).

`http.server.ThreadingHTTPServer`, a thread a connection: every request
ends up waiting on its model's micro-batcher or scheduler, which is where
concurrency folds into device calls.

Endpoints:
  POST /predict            single-model deployments (model "default")
  POST /predict/<model>    multi-model routing
       body: {"inputs": {feed_name: nested list}, "timeout_ms": opt}
       reply: {"outputs": {fetch_name: nested list}, "model": name}
       With "format": "npz" in the body the reply is the fetches as one
       .npz archive (application/x-npz), keyed by fetch name: the port's
       addition, for outputs too large for JSON (an LM's [n, T, V] logits
       are 33M floats a row at T=1024, V=32000).
  POST /generate           generation models: continuous batching
  POST /generate/<model>   (serving/scheduler.py). "stream": true switches
                           to chunked NDJSON: one {"event": "token", ...}
                           line a decoded step as the pool makes it, then a
                           terminal {"event": "done", "outputs": ...} (or
                           {"event": "error", ...}). Without it the reply is
                           one object: {"model", "outputs": {ids, scores,
                           lengths}}
  GET  /healthz            {"status", "models", "circuits", "load" (queue
                           depth and age, slots, per-class and per-model
                           breakdowns, dispatch and sync counters),
                           "versions" (each model's program fingerprint),
                           "pid" (the serving process: an operator's or a
                           chaos test's handle on a replica)}
  GET  /stats              each model's engine, bucket and scheduler
                           accounting, and the process's kernel launch
                           counts ("kernel_launches")
  GET  /metrics            the unified Prometheus exposition of the
                           process-wide registry (obs/metrics.py)
  POST /prefill[/<model>]  disaggregated serving's prefill phase: the
                           /generate body (and "handoff_quant": "int8"
                           optionally); the reply is the request's boot state
                           as a PTHO1 handoff payload
                           (application/octet-stream, serving/disagg)
  POST /admit[/<model>]    the decode phase: the body is the bytes /prefill
       ?stream=1&timeout_ms=N  returned; the reply is /generate's, buffered
                           or streamed. A payload whose decode-state schema
                           differs from this replica's is a 409

Status mapping: 400 malformed request, 404 unknown model or route, 503
load shed, open circuit breaker or a generation pool aborted mid-step (with
Retry-After), 504 deadline exceeded, 500 engine failure. A model's /predict
and /generate share ONE CircuitBreaker; /healthz reports "degraded" while
any breaker is not closed. The model's SLO class (SLOPolicy) is the default
tier of its requests; a request may demote itself (body "slo" or the
X-PT-SLO-Class header), never promote. The request id header is adopted
when given, minted otherwise, and echoed on the reply.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from .. import profiler
from ..fleetctl.tenancy import SLO_HEADER, SLOPolicy, resolve_class
from ..obs import trace as obs_trace
from ..resilience.breaker import STATE_CODES, CircuitBreaker, CircuitOpenError
from .batcher import DeadlineError, MicroBatcher, ShedError
from .engine import BucketPolicy, ServingEngine
from .metrics import MetricSet, _sanitize

__all__ = ["ModelRegistry", "ServingServer", "make_server", "REQUEST_ID_HEADER", "SLO_HEADER"]

# the correlation-id header: adopted from the caller, echoed on responses;
# the key that stitches one request's spans across processes
REQUEST_ID_HEADER = "X-PT-Request-Id"


class ModelRegistry:
    """name -> (engine, batcher). One shared MetricSet across models, so
    /metrics is a single scrape."""

    def __init__(self, metrics: Optional[MetricSet] = None,
                 slo_policy: Optional[SLOPolicy] = None):
        self.metrics = metrics or MetricSet(stat_set=profiler.global_stat_set())
        self.slo_policy = slo_policy or SLOPolicy()
        self._models: Dict[str, Tuple[ServingEngine, MicroBatcher]] = {}

    def add(self, name: str, model_dir: Optional[str] = None,
            engine: Optional[ServingEngine] = None, batcher: Optional[MicroBatcher] = None,
            policy: Optional[BucketPolicy] = None, breaker: Optional[CircuitBreaker] = None,
            scheduler_kw: Optional[dict] = None, mesh=None, quantize: Optional[str] = None,
            device=None, **batcher_kw) -> Tuple[ServingEngine, MicroBatcher]:
        if engine is None:
            if model_dir is None:
                raise ValueError("add() needs model_dir or engine")
            engine = ServingEngine(model_dir, policy=policy, model_name=name,
                                   metrics=self.metrics, mesh=mesh, quantize=quantize,
                                   device=device)
        if batcher is None:
            # every registry-built model gets a circuit breaker: a model whose
            # engine keeps failing must 503 fast, not queue and then 500
            batcher = MicroBatcher(engine, metrics=self.metrics,
                                   breaker=breaker or CircuitBreaker(), **batcher_kw)
        if batcher.breaker is not None:
            self.metrics.gauge(f"circuit_state_{_sanitize(name)}",
                               lambda b=batcher.breaker: STATE_CODES[b.state()],
                               help="circuit breaker state (0=closed 1=half_open 2=open)")
        if engine.generation_spec() is not None:
            # the /generate path shares the /predict path's breaker: pool
            # step failures and engine failures trip ONE circuit
            engine.scheduler(breaker=batcher.breaker, **(scheduler_kw or {}))
        elif scheduler_kw:
            raise ValueError(f"model {name!r} is not a generation model; scheduler_kw "
                             f"{sorted(scheduler_kw)} has no effect")
        self._models[name] = (engine, batcher)
        return engine, batcher

    def get(self, name: str) -> Tuple[ServingEngine, MicroBatcher]:
        return self._models[name]

    def scheduler(self, name: str):
        """The model's ContinuousScheduler (started); ValueError for a
        model that does not generate."""
        engine, _ = self._models[name]
        return engine.scheduler()

    def names(self):
        return sorted(self._models)

    def start(self) -> "ModelRegistry":
        for e, b in self._models.values():
            b.start()
            if e._scheduler is not None:
                e._scheduler.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        """Stop every batcher and scheduler. drain_s > 0 lets queued work
        and streams in flight finish first, bounded by drain_s overall."""
        deadline = time.monotonic() + drain_s
        for e, b in self._models.values():
            b.stop(drain=drain_s > 0)
            if e._scheduler is not None:
                e._scheduler.stop(drain=drain_s > 0,
                                  drain_timeout_s=max(0.0, deadline - time.monotonic()))

    def stats(self) -> Dict[str, dict]:
        """Each model's engine, bucket and scheduler accounting, with the
        process's kernel launch counts (shared by its models)."""
        from ..core.graph import counter_state

        # one snapshot: every engine's lock held while the counts are read,
        # so no request is counted as dispatched without its launches
        with contextlib.ExitStack() as locks:
            for n in sorted(self._models):
                locks.enter_context(self._models[n][0]._lock)
            launches = {n: v for (_, n), v in counter_state().items()}
            out = {}
            for n, (e, b) in self._models.items():
                s = e.stats()
                if b.breaker is not None:
                    s["circuit"] = b.breaker.stats()
                s["kernel_launches"] = launches
                out[n] = s
        return out

    def circuits(self) -> Dict[str, str]:
        """Each model's circuit state ("closed" for one without a breaker)."""
        return {n: (b.breaker.state() if b.breaker is not None else "closed")
                for n, (_, b) in self._models.items()}

    def load(self) -> Dict[str, object]:
        """The /healthz load block: queue depth (predict and generation),
        active and total decode slots, the age of the oldest queued request,
        per-SLO-class depths, a per-model breakdown and the dispatch and
        sync counters."""
        now = time.monotonic()
        queue_depth = active = slots = dispatches = syncs = 0
        classes: Dict[str, int] = {}
        oldest: Optional[float] = None
        first_tok_p99 = 0.0
        per_model: Dict[str, dict] = {}
        for n, (e, b) in self._models.items():
            m_depth = len(b._q)
            m_oldest = b.oldest_enqueued()
            m_classes = b.depth_by_class()
            dispatches += e.dispatches_total
            syncs += e.syncs_total
            s = e._scheduler
            if s is not None:
                first_tok_p99 = max(first_tok_p99, s._first_tok.percentile(0.99))
                m_depth += s._aq.depth()
                g_oldest = s._aq.oldest_enqueued()
                if g_oldest is not None and (m_oldest is None or g_oldest < m_oldest):
                    m_oldest = g_oldest
                for c, d in s._aq.depth_by_class().items():
                    m_classes[c] = m_classes.get(c, 0) + d
                active += int(s._active.sum())
                slots += s.max_slots
                dispatches += s.dispatches_total
                syncs += s.syncs_total
            queue_depth += m_depth
            for c, d in m_classes.items():
                classes[c] = classes.get(c, 0) + d
            if m_oldest is not None and (oldest is None or m_oldest < oldest):
                oldest = m_oldest
            per_model[n] = {
                "queue_depth": m_depth,
                "queue_age_ms": round((now - m_oldest) * 1e3, 3) if m_oldest is not None else 0.0,
                "classes": m_classes,
                "slo_class": self.slo_policy.class_of(n),
            }
        return {
            "queue_depth": queue_depth,
            "queue_age_ms": round((now - oldest) * 1e3, 3) if oldest is not None else 0.0,
            "active_slots": active,
            "max_slots": slots,
            "free_slots": max(0, slots - active),
            "slot_occupancy": (active / slots) if slots else 0.0,
            "first_token_p99_ms": round(first_tok_p99 * 1e3, 3),
            "dispatches_total": dispatches,
            "syncs_total": syncs,
            "classes": classes,
            "models": per_model,
        }

    def versions(self) -> Dict[str, str]:
        """model -> the loaded artifact's program fingerprint."""
        return {n: e.fingerprint for n, (e, _) in self._models.items()}


class _Handler(BaseHTTPRequestHandler):
    server: "ServingServer"
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, payload, content_type="application/json", extra_headers=()):
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, **extra):
        self._send(code, {"error": message, **extra},
                   extra_headers=(("Retry-After", "1"),) if code == 503 else ())

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):
        reg = self.server.registry
        if self.path == "/healthz":
            circuits = reg.circuits()
            degraded = [n for n, s in circuits.items() if s != "closed"]
            self._send(200, {"status": "degraded" if degraded else "ok",
                             "models": reg.names(), "circuits": circuits,
                             "load": reg.load(), "versions": reg.versions(),
                             "pid": os.getpid()})
        elif self.path == "/metrics":
            self._send(200, reg.metrics.render().encode(),
                       content_type="text/plain; version=0.0.4")
        elif self.path == "/stats":
            self._send(200, reg.stats())
        else:
            self._error(404, f"no route {self.path!r}")

    def do_POST(self):
        # the disaggregated phases: /admit's body is raw bytes, not JSON, so
        # neither rides the predict/generate loop below
        for route, handler in (("/prefill", self._prefill_route), ("/admit", self._admit_route)):
            if self.path.split("?", 1)[0] == route or self.path.startswith(route + "/"):
                handler()
                return
        for route, handler in (("/predict", self._predict), ("/generate", self._generate)):
            if self.path == route:
                name = "default"
            elif self.path.startswith(route + "/"):
                name = self.path[len(route) + 1:]
            else:
                continue
            reg = self.server.registry
            try:
                engine, batcher = reg.get(name)
            except KeyError:
                self._error(404, f"unknown model {name!r}; have {reg.names()}")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                feed = engine.coerce_feed(req["inputs"])
                req["slo"] = resolve_class(reg.slo_policy.class_of(name),
                                           self.headers.get(SLO_HEADER) or req.get("slo"))
                if req.get("format", "json") not in ("json", "npz"):
                    raise ValueError(f"unknown format {req['format']!r} (json or npz)")
            except (ValueError, KeyError, TypeError) as e:
                self._error(400, f"bad request: {e}")
                return
            handler(name, engine, batcher, feed, req)
            return
        self._error(404, f"no route {self.path!r}")

    def _request_id(self, prefix: str) -> str:
        """The caller's correlation id, or a minted one."""
        return self.headers.get(REQUEST_ID_HEADER) or obs_trace.new_request_id(prefix)

    def _predict(self, name, engine, batcher, feed, req):
        rid = self._request_id("req")
        try:
            with obs_trace.span("http.predict", cat="http", model=name, request_id=rid):
                outs = batcher.predict(feed, timeout_ms=req.get("timeout_ms"),
                                       request_id=rid, slo=req.get("slo"))
        except (ShedError, CircuitOpenError) as e:
            self._error(503, str(e))
            return
        except DeadlineError as e:
            self._error(504, str(e))
            return
        except Exception as e:  # a model or engine failure
            self._error(500, f"{type(e).__name__}: {e}")
            return
        headers = ((REQUEST_ID_HEADER, rid),)
        if req.get("format") == "npz":
            buf = io.BytesIO()
            np.savez(buf, **dict(zip(engine.fetch_names, outs)))
            self._send(200, buf.getvalue(), content_type="application/x-npz",
                       extra_headers=headers)
            return
        self._send(200, {"model": name,
                         "outputs": {fn: np.asarray(o).tolist()
                                     for fn, o in zip(engine.fetch_names, outs)}},
                   extra_headers=headers)

    @staticmethod
    def _outputs_json(outputs):
        return {k: np.asarray(v).tolist() for k, v in outputs.items()}

    def _generate(self, name, engine, batcher, feed, req):
        """POST /generate[/<model>]: token-level continuous batching;
        "stream": true flushes tokens as the pool makes them."""
        if engine.generation_spec() is None:
            self._error(400, f"model {name!r} is not a generation model (no "
                             "beam_search_group op); use /predict")
            return
        try:
            sched = engine.scheduler()
        except ValueError as e:
            self._error(400, str(e))
            return
        timeout_ms = req.get("timeout_ms")
        rid = self._request_id("gen")
        if not req.get("stream"):
            try:
                with obs_trace.span("http.generate", cat="http", model=name, request_id=rid):
                    h = sched.submit(feed, timeout_ms=timeout_ms, request_id=rid,
                                     slo=req.get("slo"))
                    budget = timeout_ms / 1e3 if timeout_ms is not None else sched.timeout_s
                    outputs = h.result(timeout=budget + max(1.0, budget))
            except (ShedError, CircuitOpenError) as e:
                # GenerationAborted is a ShedError: a retryable 503
                self._error(503, str(e))
                return
            except DeadlineError as e:
                self._error(504, str(e))
                return
            except Exception as e:
                self._error(500, f"{type(e).__name__}: {e}")
                return
            self._send(200, {"model": name, "outputs": self._outputs_json(outputs)},
                       extra_headers=((REQUEST_ID_HEADER, rid),))
            return
        # streaming: admission errors map to HTTP statuses; once the stream
        # is open, failures arrive as a terminal {"event": "error"} line
        try:
            handle = sched.submit(feed, timeout_ms=timeout_ms, request_id=rid,
                                  slo=req.get("slo"))
        except (ShedError, CircuitOpenError) as e:
            self._error(503, str(e))
            return
        self._stream_handle(name, handle, timeout_ms, sched)

    def _stream_handle(self, name, handle, timeout_ms, sched) -> None:
        """Chunked NDJSON of one GenHandle's events: the tail of /generate's
        and /admit's streams."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header(REQUEST_ID_HEADER, handle.request_id)
        self.end_headers()
        budget = timeout_ms / 1e3 if timeout_ms is not None else sched.timeout_s
        try:
            with obs_trace.span("http.generate_stream", cat="http", model=name,
                                request_id=handle.request_id):
                for ev in handle.events(timeout=budget + max(1.0, budget)):
                    if ev["event"] == "done":
                        ev = {"event": "done", "model": name,
                              "outputs": self._outputs_json(ev["outputs"])}
                    self._write_chunk(json.dumps(ev).encode() + b"\n")
                self._write_chunk(b"")  # the terminal zero-length chunk
        except queue.Empty:  # no event within the request's budget
            self._write_chunk(json.dumps({"event": "error", "kind": "DeadlineError",
                                          "error": "no event within the deadline"}).encode()
                              + b"\n")
            self._write_chunk(b"")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away; the scheduler finishes the slot

    # -- the disaggregated phases (serving/disagg) -----------------------
    def _gen_target(self, route: str):
        """A /prefill or /admit path as (name, engine, scheduler, query
        options), or None once the error is sent: both serve generation
        models only."""
        u = urlparse(self.path)
        name = "default"
        if u.path.startswith(route + "/"):
            name = u.path[len(route) + 1:] or "default"
        reg = self.server.registry
        try:
            engine, _ = reg.get(name)
        except KeyError:
            self._error(404, f"unknown model {name!r}; have {reg.names()}")
            return None
        if engine.generation_spec() is None:
            self._error(400, f"model {name!r} is not a generation model (no beam_search_group "
                             f"op); {route} serves disaggregated generation only")
            return None
        try:
            sched = engine.scheduler()
        except ValueError as e:
            self._error(400, str(e))
            return None
        opts = {k: v[-1] for k, v in parse_qs(u.query).items()}
        return name, engine, sched, opts

    def _prefill_route(self):
        """POST /prefill[/<model>]: only the prefix phase; the reply is the
        request's boot state as a handoff payload for a decode replica's
        /admit."""
        from .disagg.handoff import HandoffError, pack_handoff, payload_schema

        got = self._gen_target("/prefill")
        if got is None:
            return
        name, engine, sched, _ = got
        rid = self._request_id("pf")
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            feed = engine.coerce_feed(req["inputs"])
            quant = req.get("handoff_quant")
        except (ValueError, KeyError, TypeError) as e:
            self._error(400, f"bad request: {e}")
            return
        try:
            with obs_trace.span("http.prefill", cat="http", model=name, request_id=rid):
                boots, pes = sched.prefill(feed, request_id=rid)
                payload = pack_handoff(boots, pes, payload_schema(engine.generation_meta), name,
                                       request_id=rid, quant=quant)
        except (ShedError, CircuitOpenError) as e:
            self._error(503, str(e))
            return
        except HandoffError as e:
            self._error(400, str(e))
            return
        except Exception as e:
            self._error(500, f"{type(e).__name__}: {e}")
            return
        self._send(200, payload, content_type="application/octet-stream",
                   extra_headers=((REQUEST_ID_HEADER, rid),))

    def _admit_route(self):
        """POST /admit[/<model>]?stream=1&timeout_ms=N: a handoff payload
        into the decode pool. A payload of another decode-state schema (a
        mixed-version fleet) is a 409: not retryable on a sibling of the same
        version; the fix is a rollout."""
        from .disagg.handoff import (HandoffError, HandoffSchemaError, unpack_handoff,
                                     validate_handoff)

        got = self._gen_target("/admit")
        if got is None:
            return
        name, engine, sched, opts = got
        rid = self._request_id("adm")
        length = int(self.headers.get("Content-Length", 0))
        payload = self.rfile.read(length)
        try:
            with obs_trace.span("http.admit", cat="http", model=name, request_id=rid,
                                bytes=len(payload)):
                header, boots, pes = unpack_handoff(payload)
                validate_handoff(header, engine.generation_meta)
        except HandoffSchemaError as e:
            self._error(409, str(e), kind="HandoffSchemaError")
            return
        except HandoffError as e:
            self._error(400, str(e))
            return
        reg = self.server.registry
        slo = resolve_class(reg.slo_policy.class_of(name), self.headers.get(SLO_HEADER))
        timeout_ms = int(opts["timeout_ms"]) if "timeout_ms" in opts else None
        try:
            handle = sched.submit_handoff(boots, pes, timeout_ms=timeout_ms, request_id=rid,
                                          slo=slo)
        except (ShedError, CircuitOpenError) as e:
            self._error(503, str(e))
            return
        except ValueError as e:
            self._error(400, str(e))
            return
        if opts.get("stream") in ("1", "true"):
            self._stream_handle(name, handle, timeout_ms, sched)
            return
        budget = timeout_ms / 1e3 if timeout_ms is not None else sched.timeout_s
        try:
            outputs = handle.result(timeout=budget + max(1.0, budget))
        except (ShedError, CircuitOpenError) as e:
            self._error(503, str(e))
            return
        except DeadlineError as e:
            self._error(504, str(e))
            return
        except Exception as e:
            self._error(500, f"{type(e).__name__}: {e}")
            return
        self._send(200, {"model": name, "outputs": self._outputs_json(outputs)},
                   extra_headers=((REQUEST_ID_HEADER, rid),))

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()


class ServingServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, registry: ModelRegistry):
        super().__init__(addr, _Handler)
        self.registry = registry

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        """Start the batchers and a daemon serve_forever thread (tests and
        embedders); tear down with `shutdown()`, `registry.stop()` and
        `server_close()`."""
        self.registry.start()
        t = threading.Thread(target=self.serve_forever, name="ptserving-http", daemon=True)
        t.start()
        return t


def make_server(registry: ModelRegistry, host: str = "127.0.0.1", port: int = 0) -> ServingServer:
    """Bind (port 0: one the OS assigns; read `server.port`)."""
    return ServingServer((host, port), registry)
