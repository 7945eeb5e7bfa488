"""Deterministic fault injection: named fault points + armed triggers
(paddle_tpu/resilience/faults.py:88-257, the same points, specs and
accounting, so a spec arms both packages alike).

Contract:
- Disarmed (the default), `fire()` returns after one module-global
  boolean test: no counting, no dict lookups, nothing observable.
- Armed, every `fire(point)` advances that point's hit counter; a spec
  decides whether this hit triggers, deterministically:
    * hit-targeted: `arm("ckpt.write", hit=3)` fires on exactly the 3rd
      hit (or `hits=(2, 5)` on the 2nd and 5th);
    * seeded probability: `arm("reader.next", p=0.2, seed=7)` draws from
      a private `random.Random(seed)` stream; `times=K` caps total fires.
- A triggered fault performs its `action`:
    * "raise"   - raise InjectedFault (the default);
    * "kill"    - os._exit(137), the SIGKILL exit status;
    * "corrupt" - `fire()` RETURNS the string "corrupt"; the call site
                  owns the corruption (io.save_vars truncates the payload
                  it just wrote; the trainer NaN-poisons the step's feed).
- Arming also comes from the environment so a subprocess under test is
  armed from birth: PT_FLAGS_FAULT_SPEC="ckpt.write:hit=2:action=corrupt;
  executor.step:p=0.5:seed=7" (points split on ';', options on ':').

`stats()` reports per-point hits and fires so a test can assert the fault
actually happened.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any, Dict, Iterable, Optional

from ..flags import FLAGS, define_flag

__all__ = [
    "InjectedFault",
    "KNOWN_POINTS",
    "arm",
    "arm_from_spec",
    "disarm",
    "fire",
    "reset",
    "stats",
]

define_flag("fault_spec", "",
            "deterministic fault injection spec, e.g. "
            "'ckpt.write:hit=2:action=corrupt;executor.step:p=0.5:seed=7' "
            "(env: PT_FLAGS_FAULT_SPEC). Empty = injection disarmed and "
            "every fault point a no-op")

# the fault points threaded through the runtime; arm() rejects unknown
# names so a typo'd spec fails loudly instead of silently never firing
KNOWN_POINTS = {
    "ckpt.write",       # io.save_vars, before the rename publishes the npz
    "ckpt.meta",        # io.save_checkpoint, before the completion marker
    "executor.step",    # trainer batch loop, before the step's run (a
                        # window's steps one hit each, before its run);
                        # action=corrupt NaN-poisons the batch's first
                        # floating feed slot, in a window that step's slot
                        # only (deterministic non-finite injection for
                        # StepGuard tests)
    "serving.predict",  # serving.ServingEngine.predict inside the lock, and
                        # every generation pool step
}
# (the JAX package's reader.next point waits for the port's RetryReader:
# arming it raises here)

_ACTIONS = ("raise", "kill", "corrupt")

_lock = threading.Lock()
_specs: Dict[str, "_FaultSpec"] = {}
_hits: Dict[str, int] = {}
_fired: Dict[str, int] = {}
_armed = False  # the fast-path gate: False ⇒ fire() is a no-op


class InjectedFault(RuntimeError):
    """An armed fault point triggered (action="raise")."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class _FaultSpec:
    __slots__ = ("point", "hits", "p", "rng", "times", "action")

    def __init__(self, point: str, hits: Optional[frozenset],
                 p: Optional[float], seed: int, times: Optional[int],
                 action: str):
        self.point = point
        self.hits = hits
        self.p = p
        self.rng = random.Random(seed) if p is not None else None
        self.times = times
        self.action = action

    def triggers(self, hit: int, fired_so_far: int) -> bool:
        if self.times is not None and fired_so_far >= self.times:
            return False
        if self.hits is not None:
            return hit in self.hits
        # seeded probability: one draw per hit keeps the stream aligned
        # with the hit counter, so the fire pattern is reproducible
        return self.rng.random() < self.p


def arm(point: str, hit: Optional[int] = None,
        hits: Optional[Iterable[int]] = None, p: Optional[float] = None,
        seed: int = 0, times: Optional[int] = None,
        action: str = "raise") -> None:
    """Arm one fault point. Exactly one trigger: `hit`/`hits` or `p`."""
    global _armed
    if point not in KNOWN_POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; known: {sorted(KNOWN_POINTS)}")
    if action not in _ACTIONS:
        raise ValueError(f"action must be one of {_ACTIONS}, got {action!r}")
    if (hit is None and hits is None) == (p is None):
        raise ValueError("arm() needs exactly one of hit/hits or p")
    hitset = None
    if hit is not None or hits is not None:
        hitset = frozenset([hit] if hit is not None else []) | frozenset(
            hits or [])
        if not hitset or any(h < 1 for h in hitset):
            raise ValueError(f"hit numbers are 1-based, got {sorted(hitset)}")
    if p is not None and not (0.0 <= p <= 1.0):
        raise ValueError(f"p must be in [0, 1], got {p}")
    with _lock:
        _specs[point] = _FaultSpec(point, hitset, p, seed, times, action)
        _armed = True


def disarm(point: Optional[str] = None) -> None:
    """Disarm one point (or all); hit accounting is kept until reset()."""
    global _armed
    with _lock:
        if point is None:
            _specs.clear()
        else:
            _specs.pop(point, None)
        _armed = bool(_specs)


def reset() -> None:
    """Disarm everything, zero the accounting, re-apply FLAGS.fault_spec
    (test isolation)."""
    global _armed
    with _lock:
        _specs.clear()
        _hits.clear()
        _fired.clear()
        _armed = False
    if FLAGS.fault_spec:
        arm_from_spec(FLAGS.fault_spec)


def stats() -> Dict[str, Dict[str, Any]]:
    """Per-point accounting: {'point': {'hits': n, 'fired': m, 'armed': b}}."""
    with _lock:
        points = set(_hits) | set(_fired) | set(_specs)
        return {
            pt: {"hits": _hits.get(pt, 0), "fired": _fired.get(pt, 0),
                 "armed": pt in _specs}
            for pt in sorted(points)
        }


def fire(point: str, **ctx: Any) -> Optional[str]:
    """The call-site hook. Disarmed: returns None after one boolean
    test. Armed: counts the hit; if the point's spec triggers, performs
    its action (raise InjectedFault / os._exit(137) / return "corrupt").
    `ctx` kwargs are folded into the InjectedFault message for
    diagnosis (e.g. fire("executor.step", step=self.step))."""
    if not _armed:
        return None
    with _lock:
        _hits[point] = hit = _hits.get(point, 0) + 1
        spec = _specs.get(point)
        if spec is None or not spec.triggers(hit, _fired.get(point, 0)):
            return None
        _fired[point] = _fired.get(point, 0) + 1
        action = spec.action
    if action == "corrupt":
        return "corrupt"
    if action == "kill":
        os._exit(137)  # uncatchable, like SIGKILL
    err = InjectedFault(point, hit)
    if ctx:
        err.args = (err.args[0] + " " + ", ".join(
            f"{k}={v}" for k, v in sorted(ctx.items())),)
    raise err


def arm_from_spec(spec: str) -> None:
    """Parse and apply a FLAGS.fault_spec string: entries split on ';',
    each `point:key=value:key=value`. Keys: hit, hits (comma list), p,
    seed, times, action."""
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        point, opts = parts[0].strip(), {}
        for part in parts[1:]:
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(
                    f"bad fault spec option {part!r} in {entry!r} "
                    "(expected key=value)")
            opts[k.strip()] = v.strip()
        kwargs: Dict[str, Any] = {}
        if "hit" in opts:
            kwargs["hit"] = int(opts.pop("hit"))
        if "hits" in opts:
            kwargs["hits"] = tuple(
                int(h) for h in opts.pop("hits").split(",") if h)
        if "p" in opts:
            kwargs["p"] = float(opts.pop("p"))
        if "seed" in opts:
            kwargs["seed"] = int(opts.pop("seed"))
        if "times" in opts:
            kwargs["times"] = int(opts.pop("times"))
        if "action" in opts:
            kwargs["action"] = opts.pop("action")
        if opts:
            raise ValueError(
                f"unknown fault spec options {sorted(opts)} in {entry!r}")
        arm(point, **kwargs)


# subprocesses under chaos tests are armed from birth via the env-seeded
# flag (PT_FLAGS_FAULT_SPEC) — parse it once at import
if FLAGS.fault_spec:
    arm_from_spec(FLAGS.fault_spec)
