"""The autoscaler: a hysteresis control loop over fleet obs signals
(paddle_tpu/fleetctl/autoscaler.py).

Reference lineage: the Go master re-dispatches shards when trainers
come and go, but the fleet SIZE is an operator constant. A serving
fleet facing diurnal traffic ("heavy traffic from millions of users") wastes chips at night and sheds users at noon unless
something closes the loop. This module is that something:

    signals  — one PURE read over the router's cached replica
               snapshots (queue depth, queue age, slot occupancy,
               first-token p99 — all shipped in the /healthz load
               block the probe loop already fetches). No network, no
               locks beyond the router's membership lock: `signals`
               and `decide` are AST-linted against blocking I/O the
               same way Router.pick is.
    decide   — hysteresis bands with streak requirements: pressure
               must hold for `up_stable_ticks` consecutive ticks
               before a scale-up, idleness for `down_stable_ticks`
               before a scale-down, and EVERY action opens a
               `cooldown_s` window during which no further action
               fires (the classic anti-flap pair: the band keeps
               noise out, the cooldown keeps the loop from chasing
               its own transient).
    actuate  — Fleet.scale_up promotes already-warmed standbys
               (non-blocking — WarmPool keeps them /healthz-ready, so
               the reaction time is the DETECTION time plus ~0.1 s of
               promotion, not a cold model load); Fleet.scale_down
               marks the victim draining immediately and drains it in
               the background.

Reaction time is measured, not assumed: the loop records the interval
from the first tick that saw pressure to the scale-up that answered
it (`pt_autoscale_reaction_seconds` histogram + `last_reaction_s`),
which a fleet bench reports.

Everything lands in the unified obs registry under `pt_autoscale_*`
so one /metrics scrape on the router shows the control loop's
behavior next to the fleet gauges it reacts to.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..obs import metrics as obs_metrics

__all__ = ["Autoscaler", "AutoscalerConfig"]

# reaction time = pressure-first-seen -> standby promoted; with a warm
# standby this is dominated by the stable-tick requirement, so the
# grid spans ~one tick to many cooldowns
REACTION_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class AutoscalerConfig:
    """Bands + pacing for the control loop.

    The up band is deliberately LOWER-latency than the down band
    (small `up_stable_ticks`, large `down_stable_ticks`): adding a
    replica late sheds users, retiring one late only wastes a chip
    for a few seconds. Any signal crossing its up threshold counts as
    pressure; scale-down requires EVERY signal comfortably under its
    down threshold — the asymmetric-risk shape every production
    autoscaler converges on."""

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 4,
        up_queue_depth: float = 4.0,
        down_queue_depth: float = 0.5,
        up_queue_age_ms: float = 200.0,
        down_queue_age_ms: float = 20.0,
        up_occupancy: float = 0.85,
        down_occupancy: float = 0.30,
        up_first_token_p99_ms: float = 0.0,  # 0 = signal disabled
        up_stable_ticks: int = 2,
        down_stable_ticks: int = 12,
        cooldown_s: float = 3.0,
        tick_interval_s: float = 0.25,
        drain_timeout_s: float = 30.0,
    ):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        if up_queue_depth <= down_queue_depth:
            raise ValueError(
                "hysteresis band inverted: up_queue_depth "
                f"{up_queue_depth} <= down_queue_depth "
                f"{down_queue_depth}")
        if up_occupancy <= down_occupancy:
            raise ValueError(
                "hysteresis band inverted: up_occupancy "
                f"{up_occupancy} <= down_occupancy {down_occupancy}")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_queue_depth = up_queue_depth
        self.down_queue_depth = down_queue_depth
        self.up_queue_age_ms = up_queue_age_ms
        self.down_queue_age_ms = down_queue_age_ms
        self.up_occupancy = up_occupancy
        self.down_occupancy = down_occupancy
        self.up_first_token_p99_ms = up_first_token_p99_ms
        self.up_stable_ticks = up_stable_ticks
        self.down_stable_ticks = down_stable_ticks
        self.cooldown_s = cooldown_s
        self.tick_interval_s = tick_interval_s
        self.drain_timeout_s = drain_timeout_s

    def describe(self) -> Dict[str, Any]:
        return dict(vars(self))


class Autoscaler:
    """The control loop. `clock` is injectable (tests drive decide()
    deterministically); the background thread is optional — `tick()`
    is the whole loop body and a bench may call it directly."""

    def __init__(self, fleet, config: Optional[AutoscalerConfig] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 clock=time.monotonic, family: str = "pt_autoscale"):
        self.fleet = fleet
        self.cfg = config or AutoscalerConfig()
        self.clock = clock
        self.registry = registry or fleet.router.registry
        # metric family prefix: a disagg deployment runs TWO loops
        # (serving/disagg.make_phase_autoscalers), one per replica
        # class, each under its own family (pt_autoscale_prefill_*,
        # pt_autoscale_decode_*) so their counters/gauges never collide
        self.family = family
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # decision state
        self.up_streak = 0
        self.down_streak = 0
        self.last_action_at = -1e30  # no cooldown at birth
        self.pressure_since: Optional[float] = None
        self.last_reaction_s: Optional[float] = None
        self.ticks_total = 0
        self.actions: List[Dict[str, Any]] = []  # bounded event log
        # obs surface: pre-declared counters + live gauges so a scrape
        # sees the control loop from construction
        for name, help in (
            (f"{family}_up_total",
             "scale-up actions (warm standbys promoted)"),
            (f"{family}_down_total",
             "scale-down actions (replicas retired)"),
            (f"{family}_blocked_total",
             "scale-ups wanted while no warm standby was ready"),
        ):
            self.registry.declare_counter(name, help=help)
        self._reaction_hist = self.registry.histogram(
            f"{family}_reaction_seconds", buckets=REACTION_BUCKETS,
            help="pressure-first-seen to standby-promoted interval")
        self.registry.gauge(
            f"{family}_replicas",
            lambda: float(self.fleet.size()),
            help="replicas currently in the serving rotation")
        self.registry.gauge(
            f"{family}_pressure",
            lambda: 1.0 if self.pressure_since is not None else 0.0,
            help="1 while the up-pressure signal is crossed")

    # -- signal read (PURE — AST-linted, like Router.pick) --------------
    def signals(self) -> Dict[str, float]:
        """One aggregate reading over the router's cached snapshots.
        Every number here was fetched by the probe loop's last
        /healthz round-trip — this method itself never touches the
        network or sleeps."""
        reps = [r for r in self.fleet.router.replicas()
                if not r.draining]
        n = len(reps)
        depth = age = occ = p99 = 0.0
        for r in reps:
            snap = r.snapshot
            depth += float(snap.get("queue_depth", 0)) + r.inflight
            age = max(age, float(snap.get("queue_age_ms", 0.0)))
            occ += float(snap.get("slot_occupancy", 0.0))
            p99 = max(p99, float(snap.get("first_token_p99_ms", 0.0)))
        return {
            "replicas": float(n),
            "queue_depth_per_replica": (depth / n) if n else 0.0,
            "queue_age_ms": age,
            "slot_occupancy": (occ / n) if n else 0.0,
            "first_token_p99_ms": p99,
        }

    # -- decision (PURE — AST-linted) -----------------------------------
    def decide(self, sig: Dict[str, float],
               now: float) -> Optional[str]:
        """"up" / "down" / None for one signal reading. Mutates only
        the streak/pressure bookkeeping — actuation is tick()'s job,
        so tests drive this with synthetic signals and a fake clock."""
        cfg = self.cfg
        n = sig["replicas"]
        pressure = (
            sig["queue_depth_per_replica"] >= cfg.up_queue_depth
            or sig["queue_age_ms"] >= cfg.up_queue_age_ms
            or sig["slot_occupancy"] >= cfg.up_occupancy
            or (cfg.up_first_token_p99_ms > 0.0
                and sig["first_token_p99_ms"]
                >= cfg.up_first_token_p99_ms)
        )
        idle = (
            sig["queue_depth_per_replica"] <= cfg.down_queue_depth
            and sig["queue_age_ms"] <= cfg.down_queue_age_ms
            and sig["slot_occupancy"] <= cfg.down_occupancy
        )
        if pressure:
            if self.pressure_since is None:
                self.pressure_since = now
            self.up_streak += 1
            self.down_streak = 0
        elif idle:
            self.pressure_since = None
            self.down_streak += 1
            self.up_streak = 0
        else:
            # inside the hysteresis band: hold position
            self.pressure_since = None
            self.up_streak = 0
            self.down_streak = 0
        if now - self.last_action_at < cfg.cooldown_s:
            return None
        if (self.up_streak >= cfg.up_stable_ticks
                and n < cfg.max_replicas):
            return "up"
        if (self.down_streak >= cfg.down_stable_ticks
                and n > cfg.min_replicas):
            return "down"
        return None

    # -- one loop body (NO blocking I/O — AST-linted) -------------------
    def tick(self) -> Optional[str]:
        """signals → decide → actuate. Non-blocking end to end:
        scale_up only takes already-ready standbys, scale_down drains
        in a background thread. Returns the action taken (for benches
        driving the loop manually)."""
        now = self.clock()
        self.ticks_total += 1
        sig = self.signals()
        action = self.decide(sig, now)
        if action == "up":
            promoted = self.fleet.scale_up(1)
            if not promoted:
                # wanted a replica, none warmed yet: count it, keep
                # the streak so the NEXT ready standby is taken
                # immediately, and don't burn the cooldown
                self.registry.counter_inc(
                    f"{self.family}_blocked_total")
                return None
            reaction = (now - self.pressure_since
                        if self.pressure_since is not None else 0.0)
            self.last_reaction_s = reaction
            self._reaction_hist.observe(reaction)
            self.registry.counter_inc(f"{self.family}_up_total")
            self._note(now, "up", promoted, sig, reaction)
            self.up_streak = 0
            self.pressure_since = None
            self.last_action_at = now
            return "up"
        if action == "down":
            retired = self.fleet.scale_down(
                1, drain_timeout_s=self.cfg.drain_timeout_s)
            if not retired:
                return None
            self.registry.counter_inc(f"{self.family}_down_total")
            self._note(now, "down", retired, sig, None)
            self.down_streak = 0
            self.last_action_at = now
            return "down"
        return None

    def _note(self, now: float, action: str, names: List[str],
              sig: Dict[str, float],
              reaction: Optional[float]) -> None:
        self.actions.append({
            "t": now, "action": action, "replicas": names,
            "signals": dict(sig),
            **({"reaction_s": reaction}
               if reaction is not None else {}),
        })
        del self.actions[:-256]  # bounded event log

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pt-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.tick_interval_s):
            try:
                self.tick()
            except Exception:
                import traceback

                traceback.print_exc()  # the loop must survive a tick

    # -- introspection --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        reg = self.registry
        return {
            "config": self.cfg.describe(),
            "replicas": self.fleet.size(),
            "ticks_total": self.ticks_total,
            "up_total": reg.counter_value(f"{self.family}_up_total"),
            "down_total": reg.counter_value(
                f"{self.family}_down_total"),
            "blocked_total": reg.counter_value(
                f"{self.family}_blocked_total"),
            "last_reaction_s": self.last_reaction_s,
            "pressure": self.pressure_since is not None,
            "recent_actions": self.actions[-10:],
        }
