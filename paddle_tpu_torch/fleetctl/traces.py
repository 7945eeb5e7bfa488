"""Seeded, bit-identically replayable load traces for fleet benches
(paddle_tpu/fleetctl/traces.py: the same spec gives the same events and
digest in both packages).

An autoscaler claim ("fewer SLO-violation-minutes than a static fleet
at equal peak chips") is only as good as the load that produced it —
a bench that draws fresh randomness per run can't be compared across
commits. A trace here is a plain list of event dicts, fully
determined by (TraceSpec, seed):

    {"t": arrival seconds, "model": name, "slo": class,
     "service_ms": simulated work, "tokens": stream length}

Three load shapes compose, all from one `random.Random(seed)` (the
stdlib generator is specified to be reproducible across platforms, so
the same spec yields the same byte-exact trace on any machine):

- DIURNAL RAMP — sinusoidal rate modulation around `base_rps`
  (amplitude + period), the slow breathing an autoscaler should track
  by scaling down as much as up;
- FLASH CROWD — rate multiplier over a window (start fraction,
  duration, multiplier): the step change that separates a reactive
  scaler from a dead one. The acceptance test pins that scale-up
  fires BEFORE any interactive-tier shed inside this window;
- HEAVY TAIL — Pareto-distributed service times (bounded), so slot
  occupancy spikes come from a few giant requests, not just arrival
  rate — the regime where queue-depth and occupancy signals disagree.

Arrivals are a non-homogeneous Poisson process generated by THINNING
(Lewis-Shedler): draw candidates at the peak rate, keep each with
probability rate(t)/peak. Thinning consumes randomness in an order
independent of acceptance decisions... almost — rejection draws do
advance the stream, which is exactly why the whole trace is generated
ONCE and replayed, never re-drawn: `trace_digest` (sha256 over the
canonical JSON) is the replay identity the bench records next to its
results.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .tenancy import INTERACTIVE, _check_class

__all__ = ["TraceSpec", "generate_trace", "trace_digest"]


class TraceSpec:
    """Parameters of one synthetic load trace. Everything is plain
    data; `describe()` round-trips through JSON so a bench can record
    the exact spec beside the digest."""

    def __init__(
        self,
        duration_s: float = 60.0,
        seed: int = 0,
        base_rps: float = 20.0,
        diurnal_amplitude: float = 0.5,
        diurnal_period_s: float = 40.0,
        flash_crowds: Sequence[Tuple[float, float, float]] = (
            (0.55, 6.0, 4.0),),
        models: Sequence[Tuple[str, float, str]] = (
            ("default", 1.0, INTERACTIVE),),
        pareto_alpha: float = 1.6,
        service_ms_scale: float = 4.0,
        max_service_ms: float = 250.0,
        stream_fraction: float = 0.0,
        stream_tokens: int = 8,
        shared_prefix_fraction: float = 0.0,
        prefix_groups: int = 4,
        disagg_fraction: float = 0.0,
        prefill_ms_mu: float = 3.0,
        prefill_ms_sigma: float = 0.8,
        max_prefill_ms: float = 400.0,
        decode_tokens_min: int = 2,
        decode_tokens_max: int = 16,
    ):
        if duration_s <= 0:
            raise ValueError("duration_s must be positive")
        if base_rps <= 0:
            raise ValueError("base_rps must be positive")
        if not 0.0 <= diurnal_amplitude < 1.0:
            raise ValueError(
                "diurnal_amplitude must be in [0, 1) so the rate "
                "never goes negative")
        if pareto_alpha <= 1.0:
            raise ValueError(
                "pareto_alpha must exceed 1 (finite mean service time)")
        if not models:
            raise ValueError("need at least one (model, weight, class)")
        for start_frac, dur, mult in flash_crowds:
            if not 0.0 <= start_frac <= 1.0:
                raise ValueError("flash crowd start must be a fraction "
                                 "of the trace duration")
            if dur <= 0 or mult < 1.0:
                raise ValueError("flash crowd needs positive duration "
                                 "and multiplier >= 1")
        for _, weight, cls in models:
            if weight <= 0:
                raise ValueError("model weights must be positive")
            _check_class(cls)
        if not 0.0 <= shared_prefix_fraction <= 1.0:
            raise ValueError(
                "shared_prefix_fraction must be in [0, 1]")
        if prefix_groups < 1:
            raise ValueError("prefix_groups must be >= 1")
        if not 0.0 <= disagg_fraction <= 1.0:
            raise ValueError("disagg_fraction must be in [0, 1]")
        if prefill_ms_sigma < 0:
            raise ValueError("prefill_ms_sigma must be >= 0")
        if not 1 <= decode_tokens_min <= decode_tokens_max:
            raise ValueError(
                "need 1 <= decode_tokens_min <= decode_tokens_max")
        self.duration_s = float(duration_s)
        self.seed = int(seed)
        self.base_rps = float(base_rps)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.diurnal_period_s = float(diurnal_period_s)
        self.flash_crowds = tuple(
            (float(s), float(d), float(m)) for s, d, m in flash_crowds)
        self.models = tuple(
            (str(n), float(w), str(c)) for n, w, c in models)
        self.pareto_alpha = float(pareto_alpha)
        self.service_ms_scale = float(service_ms_scale)
        self.max_service_ms = float(max_service_ms)
        self.stream_fraction = float(stream_fraction)
        self.stream_tokens = int(stream_tokens)
        self.shared_prefix_fraction = float(shared_prefix_fraction)
        self.prefix_groups = int(prefix_groups)
        self.disagg_fraction = float(disagg_fraction)
        self.prefill_ms_mu = float(prefill_ms_mu)
        self.prefill_ms_sigma = float(prefill_ms_sigma)
        self.max_prefill_ms = float(max_prefill_ms)
        self.decode_tokens_min = int(decode_tokens_min)
        self.decode_tokens_max = int(decode_tokens_max)

    def rate(self, t: float) -> float:
        """Instantaneous arrival rate (req/s) at trace time t."""
        r = self.base_rps * (
            1.0 + self.diurnal_amplitude
            * math.sin(2.0 * math.pi * t / self.diurnal_period_s))
        for start_frac, dur, mult in self.flash_crowds:
            start = start_frac * self.duration_s
            if start <= t < start + dur:
                r *= mult
        return r

    def peak_rate(self) -> float:
        """Upper bound on rate(t) — the thinning envelope."""
        peak_mult = max(
            [m for _, _, m in self.flash_crowds], default=1.0)
        return self.base_rps * (1.0 + self.diurnal_amplitude) * peak_mult

    def describe(self) -> Dict[str, Any]:
        return {
            "duration_s": self.duration_s,
            "seed": self.seed,
            "base_rps": self.base_rps,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_s": self.diurnal_period_s,
            "flash_crowds": [list(fc) for fc in self.flash_crowds],
            "models": [list(m) for m in self.models],
            "pareto_alpha": self.pareto_alpha,
            "service_ms_scale": self.service_ms_scale,
            "max_service_ms": self.max_service_ms,
            "stream_fraction": self.stream_fraction,
            "stream_tokens": self.stream_tokens,
            "shared_prefix_fraction": self.shared_prefix_fraction,
            "prefix_groups": self.prefix_groups,
            "disagg_fraction": self.disagg_fraction,
            "prefill_ms_mu": self.prefill_ms_mu,
            "prefill_ms_sigma": self.prefill_ms_sigma,
            "max_prefill_ms": self.max_prefill_ms,
            "decode_tokens_min": self.decode_tokens_min,
            "decode_tokens_max": self.decode_tokens_max,
        }


def generate_trace(spec: TraceSpec,
                   seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Materialize the full event list for SPEC. Same (spec, seed) →
    byte-identical trace; `seed` overrides spec.seed for sweeps."""
    rng = random.Random(spec.seed if seed is None else seed)
    peak = spec.peak_rate()
    weights = [w for _, w, _ in spec.models]
    total_w = sum(weights)
    events: List[Dict[str, Any]] = []
    t = 0.0
    while True:
        # thinning: candidate at the envelope rate, keep w.p. rate/peak
        t += rng.expovariate(peak)
        if t >= spec.duration_s:
            break
        if rng.random() * peak > spec.rate(t):
            continue
        # which model (weighted), hence which SLO class
        pick = rng.random() * total_w
        for name, w, cls in spec.models:
            pick -= w
            if pick <= 0:
                break
        service_ms = min(
            spec.service_ms_scale * rng.paretovariate(spec.pareto_alpha),
            spec.max_service_ms)
        ev: Dict[str, Any] = {
            # rounded so digesting/serializing never depends on float
            # repr jitter from arithmetic reordering
            "t": round(t, 6),
            "model": name,
            "slo": cls,
            "service_ms": round(service_ms, 3),
        }
        if spec.stream_fraction and rng.random() < spec.stream_fraction:
            ev["stream"] = True
            ev["tokens"] = spec.stream_tokens
        # SHARED-PREFIX MIX (generation serving v3 bench): a fraction
        # of requests carry a prefix-group id — every request in a
        # group shares the same prompt prefix, so a prefix cache should
        # hit on all but the group's first arrival. Both draws are
        # guarded so fraction=0 specs consume NO extra randomness:
        # traces generated before this field existed replay
        # byte-identically (trace_digest stability).
        if spec.shared_prefix_fraction \
                and rng.random() < spec.shared_prefix_fraction:
            ev["prefix_group"] = rng.randrange(spec.prefix_groups)
        # DISAGG MIX (the disaggregated-serving bench): a fraction of requests carry an
        # explicit phase split — a LOGNORMAL prefill cost (long-prompt
        # encodes are multiplicative: tokenize × depth × length, so
        # their tail is log-scale heavy) and a SHORT uniform decode
        # budget. This is the regime where monolithic serving suffers
        # head-of-line blocking: a fat prefill parks in front of
        # cheap decode work. Same guarded-draw contract as above —
        # fraction=0 specs consume NO randomness, so pre-disagg traces
        # replay byte-identically (digest stability is tested).
        if spec.disagg_fraction and rng.random() < spec.disagg_fraction:
            ev["prefill_ms"] = round(
                min(rng.lognormvariate(spec.prefill_ms_mu,
                                       spec.prefill_ms_sigma),
                    spec.max_prefill_ms), 3)
            ev["decode_tokens"] = rng.randint(spec.decode_tokens_min,
                                              spec.decode_tokens_max)
        events.append(ev)
    return events


def trace_digest(events: Sequence[Dict[str, Any]]) -> str:
    """sha256 over the canonical JSON of EVENTS — the replay identity
    a bench records so a later run can prove it drove the same load."""
    blob = json.dumps(list(events), sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()
