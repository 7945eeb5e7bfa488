"""Post-training int8 quantization of inference artifacts (the JAX
package's paddle_tpu/quant):

  1. `calibrate(program, samples)` runs sample feeds through the inference
     program and records each quantizable site's activation absmax;
  2. `convert(program, scope, calib)` rewrites the program and scope in
     place: weights become int8 payloads with f32 per-column scale vars,
     `mul`/`matmul` sites become `quantized_mul`/`quantized_matmul`
     (ops/quant_kernels.py); what it cannot quantize stays fp, and its
     report says so;
  3. `io.save_inference_model` writes the `quant` sidecar with the
     program's fingerprint and a digest of the scales, which
     `io.load_inference_model` checks.

`stats()` holds this process's quant activity, which the JAX package
exports as pt_quant_* gauges; the port's exporter waits for its `obs`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .calibrate import CalibrationResult, calibrate, quantizable_sites
from .convert import SCALE_SUFFIX, QuantReport, convert

__all__ = ["CalibrationResult", "calibrate", "quantizable_sites", "QuantReport", "convert",
           "SCALE_SUFFIX", "stats", "note_convert", "note_serving", "reset_stats"]

_STATS: Dict[str, float] = {
    "sites_quantized": 0,
    "sites_skipped": 0,
    "bytes_saved": 0,
    "accuracy_delta": 0.0,
}
_ACTIVE = False


def note_convert(report: "QuantReport") -> None:
    global _ACTIVE
    _ACTIVE = True
    _STATS["sites_quantized"] += len(report.quantized)
    _STATS["sites_skipped"] += len(report.skipped)
    _STATS["bytes_saved"] += report.bytes_saved
    if report.accuracy_delta is not None:
        _STATS["accuracy_delta"] = float(report.accuracy_delta)


def note_serving(meta: Optional[Dict[str, Any]]) -> None:
    """Fold a loaded artifact's quant sidecar into this process's stats."""
    global _ACTIVE
    if not meta:
        return
    _ACTIVE = True
    _STATS["sites_quantized"] += int(meta.get("sites", 0))
    _STATS["bytes_saved"] += int(meta.get("bytes_saved", 0))
    if meta.get("accuracy_delta") is not None:
        _STATS["accuracy_delta"] = float(meta["accuracy_delta"])


def stats() -> Dict[str, float]:
    """The current stats; an empty dict when nothing was quantized or
    served quantized in this process."""
    return dict(_STATS) if _ACTIVE else {}


def reset_stats() -> None:
    global _ACTIVE
    _ACTIVE = False
    for k in _STATS:
        _STATS[k] = 0 if k != "accuracy_delta" else 0.0
