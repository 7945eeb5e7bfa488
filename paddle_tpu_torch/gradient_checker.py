"""Finite-difference gradient checking (paddle_tpu/gradient_checker.py),
the reference's test oracle (gserver/tests/test_LayerGrad.cpp, Fluid's
OpTest.check_grad).

The analytic side is the port's `autodiff` op (core/backward.py: autograd
over the forward ops); the numeric side central differences on sampled
elements of each parameter. Both run through one Executor on a for_test
clone of the program, so the check covers the whole run path, not an
isolated kernel, in the dtype the program trains in.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .core.backward import append_backward
from .core.executor import Executor, Scope, global_scope
from .core.program import Variable, grad_var_name
from .core.sparse import SelectedRows

__all__ = ["check_gradient"]


def check_gradient(loss: Variable, feed: Dict[str, object], params: Optional[Sequence[str]] = None,
                   scope: Optional[Scope] = None, eps: float = 1e-3, rtol: float = 1e-2,
                   atol: float = 1e-4, max_elements: int = 8, seed: int = 7,
                   device=None) -> Dict[str, float]:
    """Compare analytic against numeric d(loss)/d(param) on sampled
    elements (all of a parameter with at most `max_elements`, else that
    many drawn by RandomState(seed)). Runs on a for_test clone of the
    program (its optimizer pass stripped, random_seed fixed) over a copy of
    the persistables, so the caller's program and scope are untouched; on
    the card unless `device` names another. Returns {param: the largest
    |analytic - numeric|}; raises AssertionError at the first element
    beyond atol + rtol·max(|analytic|, |numeric|)."""
    src_scope = scope or global_scope()
    prog = loss.block.program.clone(for_test=True)
    prog.random_seed = seed
    block = prog.global_block()
    loss_var = block.var(loss.name)
    if params is None:
        params = [p.name for p in prog.parameters() if p.trainable]
    append_backward(loss_var, parameter_list=[block.var(p) for p in params])

    exe = Executor(device=device)
    work = Scope()
    for v in prog.persistables():
        if src_scope.has(v.name):
            work.set(v.name, src_scope.get(v.name).detach().to(exe.device).clone())

    def run(fetch_grads: bool):
        fetch = [loss_var.name] + ([grad_var_name(p) for p in params] if fetch_grads else [])
        outs = exe.run(prog, feed=dict(feed), fetch_list=fetch, scope=work, return_numpy=False)
        return [(o.to_dense() if isinstance(o, SelectedRows) else o).double().cpu().numpy()
                for o in outs]

    grads = dict(zip(params, run(True)[1:]))
    rng = np.random.RandomState(seed)
    max_diffs: Dict[str, float] = {}
    for p in params:
        value = work.get(p)
        n = value.numel()
        idxs = np.arange(n) if n <= max_elements else rng.choice(n, size=max_elements,
                                                                 replace=False)
        worst = 0.0
        for i in idxs:
            losses = []
            for delta in (eps, -eps):
                bumped = value.clone()
                bumped.view(-1)[int(i)] += delta
                work.set(p, bumped)
                losses.append(float(run(False)[0]))
            work.set(p, value)
            numeric = (losses[0] - losses[1]) / (2 * eps)
            a = float(grads[p].reshape(-1)[i])
            diff = abs(a - numeric)
            tol = atol + rtol * max(abs(a), abs(numeric))
            if diff > tol:
                raise AssertionError(
                    f"gradient mismatch for {p}[{i}]: analytic={a:.6g} "
                    f"numeric={numeric:.6g} (|diff|={diff:.3g} > tol={tol:.3g})")
            worst = max(worst, diff)
        max_diffs[p] = worst
    return max_diffs
