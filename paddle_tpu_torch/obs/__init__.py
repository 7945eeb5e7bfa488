"""Run-wide observability (paddle_tpu/obs): `trace`, structured span
tracing with per-thread rings and Chrome trace export, and `metrics`, one
process-wide registry behind one Prometheus text renderer.

    from paddle_tpu_torch import obs

    with obs.tracing("run.trace.json"):
        trainer.train(...)            # spans land per thread
    print(obs.registry().render())
"""

from . import metrics  # noqa: F401
from . import promparse  # noqa: F401
from . import trace  # noqa: F401
from .metrics import MetricsRegistry, registry  # noqa: F401
from .trace import Trace, span, tracing, validate_chrome_trace  # noqa: F401

__all__ = ["MetricsRegistry", "Trace", "metrics", "promparse", "registry", "span", "trace",
           "tracing", "validate_chrome_trace"]
