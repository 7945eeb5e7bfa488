"""Program rewrite: fp matmul sites → int8 ops (paddle_tpu/quant/convert.py).

In place over (program, scope): each eligible weight is stored as an int8
[K, N] payload with an f32 per-column scale var `<w>@quant_scale`
(persistable, so it travels in params.npz), and each eligible site becomes
`quantized_mul`/`quantized_matmul` with its calibrated activation scale as
the `x_scale` attr. What stays fp — a site with no calibration range, a
dead activation, a weight shared across transposed sites — is named in the
report: the result is a mixed-precision program.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.executor import Executor, Scope, global_scope
from ..io import SCALE_SUFFIX, state_to_numpy
from ..ops import quant_kernels as qk
from .calibrate import CalibrationResult, quantizable_sites

_QUANT_OP = {"mul": "quantized_mul", "matmul": "quantized_matmul"}


class QuantReport:
    """What the converter did and, by name, what it did not."""

    def __init__(self, mode: str, quantized: List[Dict[str, Any]],
                 skipped: List[Dict[str, Any]], kept_fp_ops: int, bytes_saved: int,
                 sample_count: int, accuracy_delta: Optional[float] = None):
        self.mode = mode
        self.quantized = quantized
        self.skipped = skipped
        self.kept_fp_ops = kept_fp_ops
        self.bytes_saved = bytes_saved
        self.sample_count = sample_count
        self.accuracy_delta = accuracy_delta

    def meta(self) -> Dict[str, Any]:
        """The artifact's `quant` sidecar, less the fingerprint and digest
        that io.save_inference_model adds."""
        return {
            "mode": self.mode,
            "sites": len(self.quantized),
            "skipped": len(self.skipped),
            "calibration_samples": self.sample_count,
            "bytes_saved": int(self.bytes_saved),
            **({"accuracy_delta": float(self.accuracy_delta)}
               if self.accuracy_delta is not None else {}),
        }

    def summary(self) -> str:
        lines = [f"quantized {len(self.quantized)} matmul sites to {self.mode} "
                 f"({self.bytes_saved / 1024:.1f} KiB of weight bytes saved; calibrated on "
                 f"{self.sample_count} samples)"]
        for q in self.quantized:
            lines.append(f"  {q['op']}: {q['w']} [{q['K']}x{q['N']}] int8 per-channel, "
                         f"x_scale={q['x_scale']:.3g}")
        if self.skipped:
            lines.append(f"  LEFT AT HIGHER PRECISION ({len(self.skipped)} candidate sites — "
                         "mixed-precision program):")
            for s in self.skipped:
                lines.append(f"    {s['op']}: {s['reason']}")
        lines.append(f"  {self.kept_fp_ops} non-matmul ops keep their original precision "
                     "(amp.precision_policy: high/follow)")
        if self.accuracy_delta is not None:
            lines.append(f"  accuracy check: max |quant - fp| = {self.accuracy_delta:.4g} on "
                         "the check feed")
        return "\n".join(lines)


def _site_skip_reason(site, calib: CalibrationResult,
                      quantized_layout: Dict[str, str]) -> Optional[str]:
    x, w = site["x"], site["w"]
    if x not in calib.act_ranges:
        return f"activation {x!r} has no calibration range"
    if calib.act_ranges[x] <= 0.0:
        return f"activation {x!r} calibrated to absmax 0 (dead input on the sample feed)"
    layout = "NK" if site["transpose_w"] else "KN"
    if w in quantized_layout and quantized_layout[w] != layout:
        return (f"weight {w!r} already quantized with layout {quantized_layout[w]} (shared "
                "across transposed sites)")
    return None


def convert(program, scope: Optional[Scope] = None,
            calib: Optional[CalibrationResult] = None, mode: str = "int8",
            check_feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[List[str]] = None, exe: Optional[Executor] = None,
            device=None) -> QuantReport:
    """Rewrites `program` and `scope` in place to the quantized form and
    returns the report. With check_feed and fetch_list it runs the program
    before and after and records the largest output change as
    accuracy_delta. Raises ValueError for an unknown mode, a missing
    calibration, or a program with nothing to quantize. Without `exe`,
    runs on `device` (default: the card)."""
    if mode != "int8":
        raise ValueError(f"unsupported quant mode {mode!r} (only int8)")
    scope = scope or global_scope()
    if calib is None:
        raise ValueError("convert() needs a CalibrationResult "
                         "(quant.calibrate the sample feed first)")
    exe = exe or Executor(device)
    ref_outs = None
    if check_feed is not None:
        if not fetch_list:
            raise ValueError("check_feed needs fetch_list to compare on")
        ref_outs = exe.run(program, feed=dict(check_feed), fetch_list=list(fetch_list),
                           scope=scope)

    quantized: List[Dict[str, Any]] = []
    skipped: List[Dict[str, Any]] = []
    quantized_layout: Dict[str, str] = {}
    bytes_saved = 0
    for site in quantizable_sites(program, scope):
        op, block = site["op"], program.blocks[site["block"]]
        reason = _site_skip_reason(site, calib, quantized_layout)
        if reason is not None:
            skipped.append({"op": op.type, "w": site["w"], "reason": reason})
            continue
        wname = site["w"]
        scale_name = wname + SCALE_SUFFIX
        if wname not in quantized_layout:
            t = scope.get(wname)
            w = state_to_numpy(scope, [wname])[wname]
            if site["transpose_w"]:
                w = np.ascontiguousarray(w.T)
            wq, scale = qk.quantize_weight(w)
            scope.set(wname, torch.as_tensor(wq, device=t.device))
            scope.set(scale_name, torch.as_tensor(scale, device=t.device))
            wv = block.var(wname)
            wv.dtype = np.int8
            wv.shape = tuple(wq.shape)
            block.create_var(scale_name, shape=(wq.shape[1],), dtype=np.float32,
                             persistable=True)
            quantized_layout[wname] = "NK" if site["transpose_w"] else "KN"
            bytes_saved += t.numel() * t.element_size() - (wq.size + scale.size * 4)
        x_scale = qk.act_scale(calib.act_ranges[site["x"]])
        op.type = _QUANT_OP[op.type]
        op.inputs["Scale"] = [scale_name]
        op.attrs.pop("transpose_Y", None)
        op.attrs["x_scale"] = x_scale
        op.attrs["quant_mode"] = mode
        K, N = block.var(wname).shape
        quantized.append({"op": op.type, "x": site["x"], "w": wname, "K": int(K), "N": int(N),
                          "x_scale": x_scale})
    if not quantized:
        raise ValueError(
            "convert(): no site was quantizable — " + "; ".join(
                f"{s['op']}: {s['reason']}" for s in skipped) if skipped
            else "convert(): the program has no quantizable matmul sites")
    program.bump_version()

    kept_fp = sum(1 for b in program.blocks for o in b.ops if o.type not in _QUANT_OP.values())
    accuracy_delta = None
    if ref_outs is not None:
        q_outs = exe.run(program, feed=dict(check_feed), fetch_list=list(fetch_list),
                         scope=scope)
        accuracy_delta = max(float(np.max(np.abs(np.asarray(a, np.float32)
                                                 - np.asarray(b, np.float32))))
                             for a, b in zip(ref_outs, q_outs))
    report = QuantReport(mode, quantized, skipped, kept_fp, bytes_saved, calib.sample_count,
                         accuracy_delta)
    program._quant_meta = report.meta()

    from . import note_convert

    note_convert(report)
    return report
