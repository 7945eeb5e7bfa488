"""DisaggDispatcher: the router-side phase split of /generate
(paddle_tpu/serving/disagg/dispatch.py).

A monolithic /generate routes once. Disaggregated, one request crosses
the fleet twice, and this dispatcher is the seam: JSQ-pick a PREFILL
replica (scored on queue depth + compute backlog), POST the original
request to its /prefill, take the handoff payload it returns, then PIN
a DECODE replica (scored on free slots) and POST the payload to its
/admit — whose response (buffered JSON or chunked NDJSON token stream)
is returned as an ordinary router _Lease for the existing pass-through
relay. The router handler cannot tell a disagg lease from a monolithic
one; streaming, request-id propagation and mid-stream death semantics
are all inherited.

Failure semantics: the decode-side dispatch already retries
the SAME payload on the next-best decode replica (Router.dispatch
failover — the payload is bytes, nothing is consumed by a dead TCP
connection). Only when the whole decode class refuses (NoReplicaError:
every breaker open / every replica draining, or a unanimous shed) does
the dispatcher spend ONE re-prefill on a DIFFERENT prefill replica —
breaker-gated like every pick — before relaying the retryable 503.
Mid-stream decode death is the client's retry (the relay's terminal
ReplicaLostError line), exactly as monolithic serving.

The phase-pick path (`generate` up to the first dispatch call) is
AST-linted against blocking I/O the same way Router.pick is: every
network round-trip happens inside Router.dispatch, never while
choosing where to send the request.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ...obs import trace as obs_trace
from ..metrics import HANDOFF_BUCKETS
from ..router import NoReplicaError

__all__ = ["DisaggDispatcher"]


class DisaggDispatcher:
    """Phase-split /generate over a phase-classed Router.

    `quant` ("int8") asks prefill replicas to pack float state per-row
    symmetric int8 (~2x payload cut); `max_reprefills` bounds the
    re-prefill recovery after a decode-class failure."""

    def __init__(self, router, quant: Optional[str] = None,
                 max_reprefills: int = 1):
        if quant not in (None, "int8"):
            raise ValueError(
                f"unsupported handoff quant {quant!r} (only 'int8')")
        self.router = router
        self.quant = quant
        self.max_reprefills = max_reprefills
        self.registry = router.registry
        for name, help in (
            ("pt_handoff_total",
             "prefill→decode handoffs admitted by a decode replica"),
            ("pt_handoff_bytes_total",
             "handoff payload bytes shipped prefill→decode"),
            ("pt_disagg_reprefills_total",
             "re-prefills on another replica after the decode class "
             "refused a payload"),
        ):
            self.registry.declare_counter(name, help=help)
        self._handoff_s = self.registry.histogram(
            "pt_handoff_seconds", buckets=HANDOFF_BUCKETS,
            help="prefill-completion to decode-admission transfer time")

    # -- the phase-pick + ship path (NO blocking I/O outside
    #    Router.dispatch — AST-linted like Router.pick) ------------------
    def generate(self, path: str, body: bytes,
                 request_id: Optional[str] = None,
                 slo: Optional[str] = None):
        """Serve one /generate request through the two phases; returns
        the decode-side _Lease (relay + close() belong to the caller).
        Raises NoReplicaError only when neither phase can make
        progress."""
        model = "default"
        if path.startswith("/generate/"):
            model = path[len("/generate/"):]
        # one parse to learn the stream/timeout options (they travel in
        # the /admit query string — the admit body is opaque payload
        # bytes) and to stamp the quant ask; an unparsable body is
        # forwarded as-is and the prefill replica's 400 relayed
        pf_body = body
        stream = False
        timeout_ms = None
        try:
            req = json.loads(body or b"{}")
            stream = bool(req.get("stream"))
            timeout_ms = req.get("timeout_ms")
            if self.quant:
                req["handoff_quant"] = self.quant
            pf_body = json.dumps(req).encode()
        except (ValueError, AttributeError):
            pass

        pf = self.router.dispatch(
            "/prefill/" + model, pf_body, request_id=request_id,
            slo=slo, phase="prefill")
        if pf.status != 200:
            return pf  # shed/4xx relayed verbatim (carries Retry-After)
        payload = pf.body
        used_prefill = pf.replica.name
        pf.close()

        qs = []
        if stream:
            qs.append("stream=1")
        if timeout_ms is not None:
            qs.append(f"timeout_ms={int(timeout_ms)}")
        admit_path = ("/admit/" + model
                      + ("?" + "&".join(qs) if qs else ""))
        octet = {"Content-Type": "application/octet-stream"}

        reprefills = 0
        while True:
            t0 = time.monotonic()
            self.registry.counter_inc("pt_handoff_bytes_total",
                                      by=float(len(payload)))
            lease = None
            try:
                with obs_trace.span("disagg.handoff", cat="disagg",
                                    model=model, request_id=request_id,
                                    bytes=len(payload)):
                    # internal failover retries the SAME payload on the
                    # next-best decode replica; only class-wide refusal
                    # falls out of this call
                    lease = self.router.dispatch(
                        admit_path, payload, request_id=request_id,
                        headers=octet, slo=slo, phase="decode")
            except NoReplicaError:
                pass
            if lease is not None and lease.status != 503:
                self._handoff_s.observe(time.monotonic() - t0)
                self.registry.counter_inc("pt_handoff_total")
                return lease
            # the decode class refused the payload wholesale: ONE
            # breaker-gated re-prefill on a DIFFERENT prefill replica
            # (a fresh payload + fresh picks), then the retryable 503
            if reprefills >= self.max_reprefills:
                if lease is not None:
                    return lease  # the unanimous shed's own 503
                raise NoReplicaError(
                    f"no decode replica admitted the handoff for "
                    f"{path} after {reprefills} re-prefill(s); "
                    f"retry later")
            reprefills += 1
            if lease is not None:
                lease.close()
            self.registry.counter_inc("pt_disagg_reprefills_total")
            if obs_trace._armed:
                obs_trace.instant(
                    "disagg.reprefill", cat="disagg", model=model,
                    request_id=request_id, excluded=used_prefill)
            pf = self.router.dispatch(
                "/prefill/" + model, pf_body, request_id=request_id,
                slo=slo, phase="prefill", exclude=(used_prefill,))
            if pf.status != 200:
                return pf
            payload = pf.body
            used_prefill = pf.replica.name
            pf.close()

    def stats(self):
        reg = self.registry
        return {
            "quant": self.quant,
            "handoffs_total": reg.counter_value("pt_handoff_total"),
            "handoff_bytes_total": reg.counter_value(
                "pt_handoff_bytes_total"),
            "reprefills_total": reg.counter_value(
                "pt_disagg_reprefills_total"),
        }
