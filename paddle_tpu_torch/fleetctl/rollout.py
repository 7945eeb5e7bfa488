"""Zero-downtime model rollout: warm → verify → flip → drain
(paddle_tpu/fleetctl/rollout.py).

The reference framework swaps a model by restarting pservers from a
checkpoint — downtime is the deploy story. A serving fleet cannot
blink: requests keep arriving while the artifact changes underneath
them. The rollout choreography here is the standard blue/green shape
specialized to this repo's mechanisms:

  1. WARM    — spawn one NEW-version replica per current rotation
               member (fleet.spawn_template(model_dir), the same
               spawn path `serve --replicas` uses), concurrently, and
               wait until each is /healthz-ready. The old fleet keeps
               serving; the new one costs standby chips for the
               window, not availability.
  2. VERIFY  — read the EXPECTED program fingerprint from the new
               artifact's meta.json and require every warmed replica
               to report exactly that hash for the target model on
               /healthz "versions" (io.program_fingerprint: content
               hash of the pruned program, round-trip stable). A
               replica serving the wrong bits — stale dir, racing
               writer, wrong mount — fails the rollout BEFORE any
               traffic moves; the new replicas are killed and the old
               fleet never noticed.
  3. FLIP    — Router.flip(): one lock acquisition adds the new
               replicas and marks every old one draining. After the
               flip, new picks land only on the new version; requests
               already streaming from old replicas keep their
               connection (draining ≠ dead).
  4. DRAIN   — Fleet.retire(): wait (bounded) until each old replica
               reports an empty queue and zero router-tracked
               in-flight, then remove it WITH counter-series
               retirement and SIGTERM it (cli serve's handler drains
               its own streams as a second belt). The warm pool's
               spawn_fn is repointed first, so standbys promoted
               during or after the rollout are already new-version.

The satellite test drives this mid-load with in-flight NDJSON
streams: old-version streams run to "done", new requests land on the
new fingerprint, zero client errors.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = ["RolloutError", "RolloutManager"]


class RolloutError(RuntimeError):
    """The rollout was refused or aborted BEFORE the flip: the old
    fleet is intact and still serving (this error is the safe
    outcome — nothing moved)."""


def _expected_fingerprint(model_dir: str) -> str:
    meta_path = os.path.join(model_dir, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise RolloutError(
            f"cannot read {meta_path}: {e} — is {model_dir!r} a saved "
            "inference artifact?") from None
    fp = meta.get("program_fingerprint")
    if not fp:
        raise RolloutError(
            f"{meta_path} carries no program_fingerprint (artifact "
            "predates the fleet-control format); re-export it with "
            "save_inference_model")
    return fp


class RolloutManager:
    """Runs one rollout over a Fleet. Stateless between calls; the
    fleet's spawn_template (set by `cli serve --replicas`) is how new-
    version replicas are created with the fleet's own serve flags."""

    def __init__(self, fleet, spawn_template=None):
        self.fleet = fleet
        self.spawn_template = spawn_template or fleet.spawn_template
        if self.spawn_template is None:
            raise RolloutError(
                "fleet has no spawn_template: attach one (model_dir -> "
                "spawn_fn) before rolling out")

    def rollout(self, model_dir: str, model: str = "default",
                ready_timeout_s: Optional[float] = None,
                drain_timeout_s: float = 30.0) -> Dict[str, Any]:
        """Warm → verify → flip → drain. Returns the report dict; a
        RolloutError before the flip leaves the old fleet untouched."""
        fleet = self.fleet
        t0 = time.monotonic()
        expected = _expected_fingerprint(model_dir)
        old_names = sorted(fleet._procs)
        if not old_names:
            raise RolloutError("fleet has no replicas to roll")
        current = {
            v for r in fleet.router.replicas()
            if r.name in old_names
            for v in [r.versions.get(model)] if v
        }
        if current == {expected}:
            return {"status": "noop", "fingerprint": expected,
                    "replicas": old_names,
                    "detail": "fleet already serves this version"}
        spawn_fn = self.spawn_template(model_dir)
        timeout = (ready_timeout_s if ready_timeout_s is not None
                   else fleet.ready_timeout_s)
        # 1. WARM: one new replica per rotation member, concurrently
        news = [spawn_fn() for _ in old_names]
        try:
            for p in news:
                p.wait_ready(timeout=timeout)
            # 2. VERIFY: every warmed replica must report the expected
            # fingerprint for the target model before traffic moves
            for p in news:
                got = self._probe_version(p.url, model)
                if got != expected:
                    raise RolloutError(
                        f"version verify failed on {p.url}: expected "
                        f"program fingerprint {expected}, replica "
                        f"reports {got!r} for model {model!r} — "
                        "rollout aborted, old fleet untouched")
        except Exception:
            for p in news:
                p.kill()
            raise
        # 3. FLIP: atomic — new replicas join, old ones drain, under
        # ONE router lock acquisition. Repoint spawns FIRST so a
        # standby promoted mid-flip is already new-version.
        fleet.set_spawn_fn(spawn_fn)
        added = fleet.router.flip(
            add=[(p.url, p) for p in news], drain=old_names)
        for client, p in zip(added, news):
            p.name = client.name
            fleet._procs[client.name] = p
        flipped_at = time.monotonic()
        # 4. DRAIN: old version finishes what it has, then leaves the
        # registry (counter series retired — deliberate retirement)
        fleet.retire(old_names, drain_timeout_s=drain_timeout_s)
        return {
            "status": "ok",
            "fingerprint": expected,
            "model": model,
            "old": old_names,
            "new": [c.name for c in added],
            "flip_s": round(flipped_at - t0, 3),
            "total_s": round(time.monotonic() - t0, 3),
        }

    @staticmethod
    def _probe_version(url: str, model: str) -> Optional[str]:
        import urllib.request

        try:
            with urllib.request.urlopen(url + "/healthz",
                                        timeout=5.0) as f:
                payload = json.loads(f.read().decode())
        except Exception as e:
            raise RolloutError(
                f"cannot probe {url}/healthz during verify: "
                f"{type(e).__name__}: {e}") from None
        return (payload.get("versions") or {}).get(model)
