"""DisaggFleet: one warm pool, two replica classes, two control loops
(paddle_tpu/serving/disagg/fleet.py).

The fleet layer's piece of disaggregation is CLASS MEMBERSHIP, not
process shape: every replica is the same `serve` binary (it answers
/generate, /prefill and /admit alike), so a WarmPool standby is
promotable into EITHER class and the class is assigned at router
registration time. Assignment is deficit-based against per-class
targets — when the supervisor replaces a dead prefill replica, the
prefill class is the one short a member, so the promoted standby lands
there; an autoscaler's targeted scale_up bumps its class's target and
registers into it explicitly.

Each class then gets its OWN stock Autoscaler via the PhaseFleet
adapter: the prefill loop sees only prefill replicas (its pressure is
queue depth/age — compute backlog), the decode loop only decode
replicas (its pressure is slot occupancy). Neither loop knows disagg
exists; `family=` keeps their metric families apart
(pt_autoscale_prefill_*, pt_autoscale_decode_*).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ...fleetctl.autoscaler import Autoscaler, AutoscalerConfig
from ..router import (Fleet, ReplicaClient, ReplicaProcess, Router)

__all__ = ["DisaggFleet", "PhaseFleet", "PhaseAutoscalers",
           "make_phase_autoscalers"]

PHASES = ("prefill", "decode")


class DisaggFleet(Fleet):
    """A Fleet whose rotation is split into prefill/decode classes."""

    def __init__(self, spawn_fn, prefill_replicas: int = 1,
                 decode_replicas: int = 1, standby: int = 0,
                 router: Optional[Router] = None, **kw):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError(
                f"a disagg fleet needs >= 1 replica per class, got "
                f"prefill={prefill_replicas} decode={decode_replicas}")
        # per-class DESIRED sizes; deficit assignment and the >=1
        # floors key off these, and targeted scaling moves them
        self.targets: Dict[str, int] = {"prefill": int(prefill_replicas),
                                        "decode": int(decode_replicas)}
        super().__init__(spawn_fn,
                         replicas=prefill_replicas + decode_replicas,
                         standby=standby, router=router, **kw)

    # -- class membership ----------------------------------------------
    def phase_counts(self) -> Dict[str, int]:
        """Live (non-draining, supervised) members per class."""
        counts = {ph: 0 for ph in PHASES}
        for r in self.router.replicas():
            if (r.phase in counts and not r.draining
                    and r.name in self._procs):
                counts[r.phase] += 1
        return counts

    def _register(self, p: ReplicaProcess,
                  phase: Optional[str] = None) -> ReplicaClient:
        # deficit-based assignment: a phase-agnostic standby (start(),
        # supervisor replacement) joins whichever class is furthest
        # below its target — this is what makes ONE warm pool serve
        # both classes
        if phase is None:
            counts = self.phase_counts()
            deficits = {ph: self.targets[ph] - counts[ph]
                        for ph in PHASES}
            phase = ("prefill"
                     if deficits["prefill"] > deficits["decode"]
                     else "decode")
        r = self.router.add_replica(p.url, process=p, phase=phase)
        p.name = r.name
        self._procs[r.name] = p
        return r

    def adopt(self, p: ReplicaProcess,
              phase: Optional[str] = None) -> ReplicaClient:
        return self._register(p, phase=phase)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["phases"] = {ph: {"replicas": n, "target": self.targets[ph]}
                       for ph, n in self.phase_counts().items()}
        return d

    # -- per-class capacity (the phase autoscalers' actuators) ----------
    def scale_up(self, n: int = 1, phase: str = "decode") -> List[str]:
        """Promote up to `n` ready standbys INTO `phase`, bumping its
        target so a later replacement lands in the same class. Same
        non-blocking contract as Fleet.scale_up."""
        names: List[str] = []
        if self.warm is None:
            return names
        with self._scale_lock:
            for _ in range(n):
                p = self.warm.take(timeout=0.0)
                if p is None:
                    break
                self.targets[phase] += 1
                names.append(self._register(p, phase=phase).name)
        return names

    def scale_down(self, n: int = 1, drain_timeout_s: float = 30.0,
                   phase: str = "decode") -> List[str]:
        """Retire the `n` least-loaded replicas OF `phase`; at least
        one replica of each class always survives (a topology with an
        empty phase cannot serve at all)."""
        with self._scale_lock:
            candidates = [
                r for r in self.router.replicas()
                if (not r.draining and r.name in self._procs
                    and r.phase == phase)
            ]
            candidates.sort(key=lambda r: r.score())
            n = min(n, len(candidates) - 1)
            victims = [r.name for r in candidates[:max(0, n)]]
            for name in victims:
                self.targets[phase] = max(1, self.targets[phase] - 1)
                self.router.set_draining(name)
                self._retiring[name] = self._procs.pop(name)
        if victims:
            threading.Thread(
                target=self._drain_and_retire,
                args=(victims, drain_timeout_s),
                name="ptrouter-retire", daemon=True).start()
        return victims


class _PhaseRouterView:
    """The slice of a Router one phase's autoscaler reads: replicas()
    filtered to the class, same registry. Pure pass-through — the
    signal read stays AST-lint-clean."""

    def __init__(self, router: Router, phase: str):
        self._router = router
        self.phase = phase

    @property
    def registry(self):
        return self._router.registry

    def replicas(self) -> List[ReplicaClient]:
        return [r for r in self._router.replicas()
                if r.phase == self.phase]


class PhaseFleet:
    """Adapter presenting ONE class of a DisaggFleet under the stock
    Fleet actuator surface (size / scale_up / scale_down / router), so
    an unmodified Autoscaler scales a single phase."""

    def __init__(self, fleet: DisaggFleet, phase: str):
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        self.fleet = fleet
        self.phase = phase
        self.router = _PhaseRouterView(fleet.router, phase)

    def size(self) -> int:
        return self.fleet.phase_counts()[self.phase]

    def scale_up(self, n: int = 1) -> List[str]:
        return self.fleet.scale_up(n, phase=self.phase)

    def scale_down(self, n: int = 1,
                   drain_timeout_s: float = 30.0) -> List[str]:
        return self.fleet.scale_down(n, drain_timeout_s=drain_timeout_s,
                                     phase=self.phase)


class PhaseAutoscalers:
    """The pair of per-class control loops, under the one-autoscaler
    surface RouterServer/admin_fleet expects (start/stop/tick/stats)."""

    def __init__(self, prefill: Autoscaler, decode: Autoscaler):
        self.prefill = prefill
        self.decode = decode

    def start(self) -> "PhaseAutoscalers":
        self.prefill.start()
        self.decode.start()
        return self

    def stop(self) -> None:
        self.prefill.stop()
        self.decode.stop()

    def tick(self) -> Dict[str, Optional[str]]:
        return {"prefill": self.prefill.tick(),
                "decode": self.decode.tick()}

    def stats(self) -> Dict[str, Any]:
        return {"prefill": self.prefill.stats(),
                "decode": self.decode.stats()}


def make_phase_autoscalers(
        fleet: DisaggFleet,
        prefill_config: Optional[AutoscalerConfig] = None,
        decode_config: Optional[AutoscalerConfig] = None,
        **kw) -> PhaseAutoscalers:
    """Two stock Autoscalers over one DisaggFleet, each scaling its
    class on ITS phase's signal. Defaults encode the phase rooflines:

    - prefill pressure is COMPUTE BACKLOG — queue depth and queue age
      cross early; the occupancy signal is disabled (a prefill replica
      never fills decode slots, its occupancy is pinned at 0, which
      would otherwise read as permanently idle);
    - decode pressure is SLOT OCCUPANCY — the pool filling up is what
      degrades inter-token latency; queue-age pressure is left loose
      (handoffs clear the queue in one admit, age spikes are noise).
    """
    if prefill_config is None:
        prefill_config = AutoscalerConfig(
            up_queue_depth=2.0, down_queue_depth=0.25,
            up_queue_age_ms=150.0, down_queue_age_ms=10.0,
            up_occupancy=2.0, down_occupancy=0.0)
    if decode_config is None:
        decode_config = AutoscalerConfig(
            up_queue_depth=8.0, down_queue_depth=0.5,
            up_queue_age_ms=1e9, down_queue_age_ms=1e6,
            up_occupancy=0.85, down_occupancy=0.30)
    return PhaseAutoscalers(
        Autoscaler(PhaseFleet(fleet, "prefill"), prefill_config,
                   family="pt_autoscale_prefill", **kw),
        Autoscaler(PhaseFleet(fleet, "decode"), decode_config,
                   family="pt_autoscale_decode", **kw))
