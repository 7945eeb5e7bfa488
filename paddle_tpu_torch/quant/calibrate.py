"""Calibration: the absmax of each quantizable site's activation over a
sample feed (paddle_tpu/quant/calibrate.py). The activations are fetched
through the executor's ordinary run, so calibration observes the numerics
serving runs, and their absmax is taken where they lie (on the card: exact,
and nothing the size of an activation crosses to the host). The same
samples give the same ranges, so the scales digest doubles as a staleness
check.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .. import amp
from ..core.executor import Executor, Scope, global_scope
from ..core.lod import LoDArray


def quantizable_sites(program, scope: Optional[Scope] = None) -> List[Dict[str, Any]]:
    """The matmul sites the converter may rewrite: an op of
    amp.QUANTIZABLE_OPS whose precision policy is "low", with one X and
    one Y, Y a persistable 2-D parameter present in the scope, and no
    transpose on X. Returns [{block, op_idx, op, x, w, transpose_w}]."""
    scope = scope or global_scope()
    sites = []
    for bi, block in enumerate(program.blocks):
        for oi, op in enumerate(block.ops):
            if op.type not in amp.QUANTIZABLE_OPS or amp.precision_policy(op.type) != "low":
                continue
            xs, ys = op.inputs.get("X", []), op.inputs.get("Y", [])
            if len(xs) != 1 or len(ys) != 1:
                continue
            try:
                wv = block.var(ys[0])
            except KeyError:
                continue
            if not wv.persistable or not scope.has(ys[0]):
                continue  # an activation × activation product: nothing stored
            if scope.get(ys[0]).dim() != 2:
                continue
            if op.type == "matmul" and op.attrs.get("transpose_X"):
                continue
            sites.append({"block": bi, "op_idx": oi, "op": op, "x": xs[0], "w": ys[0],
                          "transpose_w": bool(op.attrs.get("transpose_Y", False))})
    return sites


class CalibrationResult:
    """absmax ranges from one calibration run: act_ranges maps each
    activation's name to its per-tensor absmax; sample_count is how many
    sample feeds contributed (meta.json records it)."""

    def __init__(self, act_ranges: Dict[str, float], sample_count: int):
        self.act_ranges = dict(act_ranges)
        self.sample_count = int(sample_count)

    def __repr__(self):
        return (f"CalibrationResult({len(self.act_ranges)} tensors, "
                f"{self.sample_count} samples)")


def calibrate(program, samples: Sequence[Dict[str, Any]], scope: Optional[Scope] = None,
              exe: Optional[Executor] = None, device=None) -> CalibrationResult:
    """Runs `samples` (feed dicts) through the inference program and
    records the per-tensor absmax of every quantizable site's activation.
    Without `exe`, runs on `device` (default: the card)."""
    if not samples:
        raise ValueError("calibrate() needs at least one sample feed")
    scope = scope or global_scope()
    exe = exe or Executor(device)
    act_names = sorted({s["x"] for s in quantizable_sites(program, scope)})
    ranges: Dict[str, float] = {n: 0.0 for n in act_names}
    if act_names:
        for feed in samples:
            outs = exe.run(program, feed=dict(feed), fetch_list=list(act_names), scope=scope,
                           return_numpy=False)
            for name, val in zip(act_names, outs):
                val = val.data if isinstance(val, LoDArray) else val
                # |x| and its max are exact in the activation's dtype
                ranges[name] = max(ranges[name], float(val.abs().amax().float()))
    return CalibrationResult(ranges, len(samples))
