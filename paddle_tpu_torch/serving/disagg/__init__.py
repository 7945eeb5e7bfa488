"""Disaggregated prefill/decode serving (phase-specialized replicas;
paddle_tpu/serving/disagg).

The reference framework's signature distributed move is the
DistributeTranspiler: rewrite ONE program into role-specialized
sub-programs (trainer/pserver) that exchange state over send/recv. This
package is the serving analog. Generation has two phases with opposite
rooflines — the encoder PREFIX is compute-bound (wants big batches
through the engine's shape buckets), the token DECODE loop is
bandwidth-bound (wants the dense device-resident slot pool) — so a
monolithic replica is mis-provisioned for one of them at any instant.

Disaggregation splits the fleet into two replica CLASSES running the
SAME artifact and the SAME server binary:

- a **prefill replica** answers POST /prefill: runs the bucketed prefix
  ops (ContinuousScheduler.prefill: no decode pool is ever
  allocated) and returns the request's boot state as a serialized
  handoff payload (handoff.py; optional int8 packing ~2x);
- a **decode replica** answers POST /admit: validates the payload's
  DecodeState schema fingerprint, restores the rows onto its own
  device (handoff.restore_handoff_rows) and admits them through the
  SAME slot copies a local prefix takes: bit-identity with monolithic serving is structural, not
  tested-into-existence;
- the **DisaggDispatcher** (router-side) gives requests phases: JSQ
  picks a prefill replica on queue depth/compute backlog, then PINS a
  decode replica on free slots at prefill completion, ships the payload
  and relays the token stream through the existing chunked-NDJSON
  pass-through. Decode death after handoff → the payload retries on
  another decode replica; when none remains, ONE breaker-gated
  re-prefill elsewhere before the retryable 503.

Fleet-wise, DisaggFleet makes WarmPool standbys promotable into EITHER
class (deficit-based assignment vs per-class targets) and PhaseFleet
adapts each class for its own stock Autoscaler — prefill scaling on
queue age, decode on slot occupancy.
"""

from .handoff import (HandoffError, HandoffSchemaError, gather_handoff_rows,  # noqa: F401
                      pack_handoff, payload_schema, restore_handoff_rows, unpack_handoff,
                      validate_handoff)
from .dispatch import DisaggDispatcher
from .fleet import DisaggFleet, PhaseFleet, make_phase_autoscalers

__all__ = [
    "HandoffError",
    "HandoffSchemaError",
    "pack_handoff",
    "unpack_handoff",
    "payload_schema",
    "validate_handoff",
    "gather_handoff_rows",
    "restore_handoff_rows",
    "DisaggDispatcher",
    "DisaggFleet",
    "PhaseFleet",
    "make_phase_autoscalers",
]
