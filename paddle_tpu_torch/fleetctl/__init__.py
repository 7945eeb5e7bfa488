"""Fleet control (paddle_tpu/fleetctl): the policy layer over the serving
fleet.

- `tenancy`    per-model SLO classes (interactive / batch): tiered
               admission and per-class JSQ scoring in the Router.
- `autoscaler` a control loop over the fleet's load signals (queue depth
               and age, slot occupancy, first-token p99) that promotes warm
               standbys under pressure and retires idle replicas, with
               hysteresis bands and a cooldown after every action.
- `rollout`    zero-downtime rollout: warm the new artifact in standby
               replicas, verify its program fingerprint, flip the router,
               drain the old version.
- `sim`        in-process simulated replicas speaking the replica wire
               protocol, for control-plane tests.
- `traces`     seeded, replayable load traces (diurnal ramps, flash
               crowds, heavy-tailed lengths, shared prefixes).

`tenancy` is imported eagerly (serving/batcher.py reads its constants); the
rest load lazily, so serving -> tenancy never cycles back through here.
"""

from .tenancy import (BATCH, INTERACTIVE, SLO_CLASSES, SLO_HEADER,  # noqa: F401
                      SLOPolicy, resolve_class)

__all__ = ["BATCH", "INTERACTIVE", "SLO_CLASSES", "SLO_HEADER", "SLOPolicy", "resolve_class",
           "Autoscaler", "AutoscalerConfig", "RolloutError", "RolloutManager", "SimReplica",
           "TraceSpec", "generate_trace"]

_LAZY = {
    "Autoscaler": "autoscaler",
    "AutoscalerConfig": "autoscaler",
    "RolloutError": "rollout",
    "RolloutManager": "rollout",
    "SimReplica": "sim",
    "TraceSpec": "traces",
    "generate_trace": "traces",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
