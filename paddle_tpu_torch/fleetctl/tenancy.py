"""Multi-tenant SLO classes: the policy vocabulary of the fleet
(paddle_tpu/fleetctl/tenancy.py).

Reference lineage: the Go master dispatches task shards to whichever
trainer asks; every task is equal. A serving fleet carrying many
versioned artifacts for many tenants cannot treat traffic that way —
"heavy traffic from millions of users" (ROADMAP north star) is a MIX
of interactive queries (a human is waiting; first-token latency is the
product) and batch work (offline scoring, evals, backfills; only
throughput matters). This module names that distinction once so every
layer enforces the same ordering:

- `INTERACTIVE` / `BATCH` — the two SLO classes. Interactive is the
  protected tier: under pressure the batch tier is shed FIRST, always
  (AdmissionQueue's two-level admission in serving/batcher.py), and
  the Router scores replicas per class so batch backlog on a replica
  does not repel the interactive traffic it still has room for.
- `SLOPolicy` — per-model class assignment plus per-class latency
  targets. A model's class is the default for its requests; a single
  request may demote itself to batch (the `"slo"` body field or the
  X-PT-SLO-Class header) — it may NOT promote itself above its
  model's class, or the batch tier would be an honor system.

The class travels with a request as a plain string attribute
(`slo_class` on the batcher/scheduler request objects) and across the
router hop as the X-PT-SLO-Class header, mirroring how the
correlation id travels (serving/server.py REQUEST_ID_HEADER).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

__all__ = ["INTERACTIVE", "BATCH", "SLO_CLASSES", "SLO_HEADER",
           "SLOPolicy", "resolve_class"]

INTERACTIVE = "interactive"
BATCH = "batch"
# admission/shed priority order: earlier = more protected. Two levels
# today; the ordering contract (shed from the back, pop from the
# front) already generalizes.
SLO_CLASSES = (INTERACTIVE, BATCH)

# the request's class crosses the router→replica hop in this header
# (mirrors REQUEST_ID_HEADER): the router stamps the class it scored
# the pick with, so the replica's admission queue tiers agree with the
# router's per-class JSQ for the same request.
SLO_HEADER = "X-PT-SLO-Class"

# default per-class latency targets (ms): what "the SLO" means when an
# operator doesn't say. Interactive is a human-perceived first-result
# bound; batch is an eventual-completion bound an autoscaler may
# trade away first.
DEFAULT_TARGETS_MS = {INTERACTIVE: 500.0, BATCH: 30000.0}


def _check_class(slo: str) -> str:
    if slo not in SLO_CLASSES:
        raise ValueError(
            f"unknown SLO class {slo!r}; expected one of {SLO_CLASSES}")
    return slo


def resolve_class(model_class: Optional[str],
                  requested: Optional[str]) -> str:
    """The class one request actually gets: the model's class unless
    the request DEMOTES itself (interactive-class model, request says
    batch). A batch-class model's requests can never claim the
    interactive tier — priority is an operator assignment, not a
    client field."""
    base = _check_class(model_class or INTERACTIVE)
    if requested is None or requested == "":
        return base
    req = _check_class(requested)
    # max() over the priority order = the LOWER priority of the two
    order = {c: i for i, c in enumerate(SLO_CLASSES)}
    return SLO_CLASSES[max(order[base], order[req])]


class SLOPolicy:
    """model name -> SLO class, plus per-class latency targets.

    Built from `--slo model=class` CLI specs or a plain dict; models not
    named default to INTERACTIVE (the safe direction: an unnamed model is
    protected, never silently sheddable)."""

    def __init__(self, classes: Optional[Dict[str, str]] = None,
                 targets_ms: Optional[Dict[str, float]] = None):
        self._classes = {m: _check_class(c)
                         for m, c in (classes or {}).items()}
        self.targets_ms = dict(DEFAULT_TARGETS_MS)
        if targets_ms:
            for c, v in targets_ms.items():
                self.targets_ms[_check_class(c)] = float(v)

    @classmethod
    def from_specs(cls, specs: Iterable[str]) -> "SLOPolicy":
        """Parse `model=class` fragments (the CLI's --slo values)."""
        classes = {}
        for spec in specs:
            model, eq, c = spec.partition("=")
            if not eq or not model:
                raise ValueError(f"--slo needs model=class, got {spec!r}")
            classes[model] = c
        return cls(classes=classes)

    def class_of(self, model: str) -> str:
        return self._classes.get(model, INTERACTIVE)

    def target_ms(self, slo: str) -> float:
        return self.targets_ms[_check_class(slo)]

    def models(self) -> Dict[str, str]:
        return dict(self._classes)

    def describe(self) -> Dict[str, object]:
        return {"models": self.models(), "targets_ms": dict(self.targets_ms)}
