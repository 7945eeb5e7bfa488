"""StepGuard: non-finite loss/grad containment for the training loop
(paddle_tpu/resilience/guard.py:53-192, the same policy):

1. every step's loss (and fetched grads, when the stats cadence fetched
   them) is checked for finiteness;
2. a non-finite step is SKIPPED: its cost never enters the pass stats,
   and the step-interval checkpoint cadence is suppressed, so poisoned
   parameters never become the "last good checkpoint";
3. after `max_consecutive` bad steps in a row the Trainer rolls back to
   the newest valid checkpoint, then runs `cooldown_steps` steps at
   `lr_factor` times the learning rate before restoring it;
4. more than `max_rollbacks` rollbacks raises NonFiniteError.

The LR cool-down scales the persistable `<optimizer>.lr` scope tensors
(optimizer/__init__.py `_lr_var`) in place of the originals, which it
keeps and puts back.

On the trainer's cadence the guard reads `observe_window(n_good, n_bad)`
from the on-device accumulator's non-finite counter: detection lags by at
most one sync window, and while the guard is hot (`in_cooldown()`) the
trainer syncs every step.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional

import torch

__all__ = ["NonFiniteError", "StepGuard"]

log = logging.getLogger("paddle_tpu_torch.resilience")


class NonFiniteError(RuntimeError):
    """Training produced non-finite values the guard could not recover
    from (no checkpoint to roll back to, or the rollback budget is
    exhausted)."""


class StepGuard:
    def __init__(self, max_consecutive: int = 3, cooldown_steps: int = 20,
                 lr_factor: float = 0.1, max_rollbacks: int = 3):
        if max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")
        if not (0.0 < lr_factor <= 1.0):
            raise ValueError("lr_factor must be in (0, 1]")
        self.max_consecutive = max_consecutive
        self.cooldown_steps = cooldown_steps
        self.lr_factor = lr_factor
        self.max_rollbacks = max_rollbacks
        self.bad_streak = 0
        self.skipped = 0
        self.rollbacks = 0
        self.cooldown_left = 0
        self._saved_lr: Dict[str, torch.Tensor] = {}

    # -- per-step hook (called by Trainer) -------------------------------
    def observe(self, cost: float, grads: Optional[Dict[str, Any]] = None,
                scope=None) -> bool:
        """Record one step's outcome. Returns True for a finite (good)
        step; False means the step must be skipped (no stats, no
        checkpoint). Ticks the LR cool-down on good steps."""
        bad = not math.isfinite(cost)
        if not bad and grads:
            # one host read for all of them (only on a stats step)
            bad = not bool(torch.stack([torch.isfinite(torch.as_tensor(g)).all()
                                        for g in grads.values()]).all())
        if bad:
            self.bad_streak += 1
            self.skipped += 1
            log.warning("StepGuard: non-finite step skipped (cost=%r, streak %d/%d)",
                        cost, self.bad_streak, self.max_consecutive)
            return False
        self.bad_streak = 0
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            if self.cooldown_left == 0 and scope is not None:
                self._restore_lr(scope)
        return True

    def observe_window(self, n_good: int, n_bad: int, scope=None) -> bool:
        """Cadence-sync variant of observe(): a window containing ANY
        non-finite step counts as a contiguous bad streak (the poisoned
        update has long been applied; rollback is the remedy). Returns
        True iff the window was clean."""
        if n_bad:
            self.bad_streak += n_bad
            self.skipped += n_bad
            log.warning("StepGuard: %d non-finite step(s) in the last sync window "
                        "(streak %d/%d)", n_bad, self.bad_streak, self.max_consecutive)
            return False
        if n_good:
            self.bad_streak = 0
            if self.cooldown_left > 0:
                self.cooldown_left = max(0, self.cooldown_left - n_good)
                if self.cooldown_left == 0 and scope is not None:
                    self._restore_lr(scope)
        return True

    def in_cooldown(self) -> bool:
        """True while the guard needs step-granular host syncs: an open
        bad streak or a running reduced-LR cool-down."""
        return self.bad_streak > 0 or self.cooldown_left > 0

    def wants_rollback(self) -> bool:
        return self.bad_streak >= self.max_consecutive

    def after_rollback(self, program, scope) -> None:
        """Called by the Trainer once the checkpoint reload is done: spend
        one rollback from the budget, start the reduced-LR cool-down."""
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise NonFiniteError(
                f"StepGuard: {self.rollbacks} rollbacks without recovery "
                f"(budget {self.max_rollbacks}) — training is not "
                "converging past the non-finite region")
        self.bad_streak = 0
        self.cooldown_left = self.cooldown_steps
        self._scale_lr(program, scope)
        log.warning("StepGuard: rolled back to last checkpoint (rollback %d/%d); "
                    "LR x%g for %d steps", self.rollbacks, self.max_rollbacks,
                    self.lr_factor, self.cooldown_steps)

    # -- LR cool-down ----------------------------------------------------
    def _lr_names(self, program, scope):
        return [v.name for v in program.persistables()
                if v.name.endswith(".lr") and scope.has(v.name)]

    def _scale_lr(self, program, scope) -> None:
        # the checkpoint reload just restored the original rates, so the
        # freshly loaded values ARE the originals to return to
        self._saved_lr = {}
        for name in self._lr_names(program, scope):
            orig = scope.get(name)
            self._saved_lr[name] = orig
            scope.set(name, (orig * self.lr_factor).to(orig.dtype))

    def _restore_lr(self, scope) -> None:
        for name, orig in self._saved_lr.items():
            if scope.has(name):
                scope.set(name, orig)
        if self._saved_lr:
            log.info("StepGuard: cool-down over, LR restored")
        self._saved_lr = {}

    # -- accounting ------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"skipped": self.skipped, "rollbacks": self.rollbacks,
                "bad_streak": self.bad_streak, "cooldown_left": self.cooldown_left}
