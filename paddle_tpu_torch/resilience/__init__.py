"""Fault injection and fault-tolerant training (paddle_tpu/resilience):

- `faults`: the deterministic fault-injection registry (named points in
  io and the trainer; no-ops when disarmed);
- checkpoint hardening lives in `io.py` (sha256 integrity in meta, atomic
  writes, newest-valid-serial fallback with corrupt-dir quarantine);
- `guard`: StepGuard, skip non-finite steps, roll back to the last
  checkpoint after K consecutive, reduced-LR cool-down;
- preemption: SIGTERM/SIGINT -> finish the batch -> emergency checkpoint
  -> PreemptedError, in Trainer.train;
- `breaker`: the serving stack's per-model CircuitBreaker.

The JAX package's `retry` waits for the port's operations surface
(ROADMAP.md, queue A, A12).
"""

from . import breaker  # noqa: F401
from . import faults  # noqa: F401
from . import guard  # noqa: F401
from .faults import InjectedFault  # noqa: F401
from .guard import NonFiniteError, StepGuard  # noqa: F401

__all__ = ["InjectedFault", "breaker", "NonFiniteError", "PREEMPT_EXIT_CODE", "PreemptedError",
           "StepGuard", "faults", "guard"]

# BSD sysexits EX_TEMPFAIL: "transient failure, retry the job", what a
# scheduler should treat as reschedule-don't-page after a preemption
PREEMPT_EXIT_CODE = 75


class PreemptedError(RuntimeError):
    """Training was interrupted by SIGTERM/SIGINT; the current batch was
    finished and (when checkpointing is configured) an emergency
    checkpoint was saved before raising."""

    def __init__(self, signame: str, checkpointed: bool):
        super().__init__(
            f"training preempted by {signame}"
            + ("; emergency checkpoint saved" if checkpointed
               else "; no checkpoint_config — progress NOT saved"))
        self.signame = signame
        self.checkpointed = checkpointed
