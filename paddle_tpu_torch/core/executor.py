"""Executor: run a Program's global block op by op on torch tensors.

The JAX package traces the block into one jitted XLA program per feed
signature (paddle_tpu/core/executor.py). PyTorch runs eagerly, so the port
walks the ops in order with no trace and no cache — the imperative
semantics the reference executor (paddle/framework/executor.cc:117-146)
has. Persistable values (parameters) live in a Scope across runs.

This slice is forward-only: an `autodiff` op raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import registry
from .lod import LoDArray
from .place import resolve_device
from .program import Program, Variable


class Scope:
    """name → runtime value store."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}

    def set(self, name: str, value) -> None:
        self.vars[name] = value

    def get(self, name: str):
        return self.vars[name]

    def has(self, name: str) -> bool:
        return name in self.vars

    def keys(self):
        return self.vars.keys()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _to_numpy(v):
    if isinstance(v, LoDArray):
        return v
    if v.dtype == torch.bfloat16:  # numpy has no bfloat16
        v = v.float()
    return v.detach().cpu().numpy()


class Executor:
    """`Executor(device).run(program, feed, fetch_list, scope)`.

    `device=None` is the card; the CPU runs only when named (core/place.py).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # bf16 GEMMs must reduce in f32, as the JAX package's
            # preferred_element_type=f32 does (ops/math_ops.dot); cuBLAS
            # may otherwise reduce split-K partial sums in bf16
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def _to_device(self, name, v):
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v, device=self.device)
        if isinstance(v, (torch.Tensor, LoDArray)):
            return v.to(self.device)
        raise TypeError(f"feed {name!r}: expected a numpy array, a tensor or a "
                        f"LoDArray, got {type(v).__name__}")

    def run(
        self,
        program: Program,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        env: Dict[str, Any] = {}
        for v in program.persistables():
            if scope.has(v.name):
                val = scope.get(v.name)
                if val.device != self.device:
                    raise ValueError(
                        f"scope value {v.name!r} lies on {val.device}, the "
                        f"executor runs on {self.device}: load the "
                        "parameters onto the executor's device")
                env[v.name] = val
        for k, v in (feed or {}).items():
            env[k] = self._to_device(k, v)
        env["@AMP@"] = program.amp_dtype

        block = program.global_block()
        with torch.inference_mode():
            for i, op in enumerate(block.ops):
                if op.type == "autodiff":
                    raise NotImplementedError(
                        "the PyTorch port is forward-only so far: autodiff "
                        "comes with the training slice (ROADMAP.md, queue A)")
                kernel = registry.get_kernel(op.type)
                try:
                    kernel(registry.OpContext(op, env))
                except Exception as e:
                    raise RuntimeError(
                        f"{e}\n  while executing op #{i} {op.type!r} "
                        f"inputs={op.inputs} outputs={op.outputs}") from e
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        return fetches
