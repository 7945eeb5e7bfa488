"""Fleet control (paddle_tpu/fleetctl), cut to `tenancy`: the SLO classes
the serving stack tiers its queues by. The autoscaler, rollouts, traces and
the simulator wait for ROADMAP.md A8c."""

from . import tenancy  # noqa: F401
