"""Optimizer update op kernels: the dense branches of `sgd`, `momentum`
and `adam` (paddle_tpu/ops/optimizer_ops.py:34-45, 48-70, 139-171) with
`_write`/`_lr` (:20-31).

Each op replaces the parameter and its state persistables in the env; the
executor writes them back to the Scope after the run. The update makes new
tensors rather than updating in place, as the JAX package's does: the state
of the NMT model is 0.86 GB, so a second copy for one op costs little."""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _write(ctx, slot_in, value):
    """Write back through an in/out slot pair (ParamOut etc.)."""
    ctx.env[ctx.op.inputs[slot_in][0]] = value
    out_slot = slot_in + "Out"
    if ctx.has_output(out_slot):
        ctx.set_output(out_slot, value)


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _dense_grad(ctx, op):
    g = ctx.input("Grad")
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            f"{op}: a {type(g).__name__} gradient (SelectedRows, from an "
            "is_sparse embedding) is not ported yet (ROADMAP.md, queue A, A7)")
    return g


@register_op("sgd")
def sgd_kernel(ctx):
    """Reference: sgd_op.cc — p -= lr * g."""
    _write(ctx, "Param", ctx.input("Param") - _lr(ctx) * _dense_grad(ctx, "sgd"))


@register_op("momentum")
def momentum_kernel(ctx):
    """Reference: momentum_op.cc — v = mu·v + g; p -= lr·v, or with
    use_nesterov p -= (g + mu·v)·lr."""
    p, g, v = ctx.input("Param"), _dense_grad(ctx, "momentum"), ctx.input("Velocity")
    mu, lr = ctx.attr("mu", 0.9), _lr(ctx)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    _write(ctx, "Velocity", v_new)
    _write(ctx, "Param", p_new)


@register_op("adam")
def adam_kernel(ctx):
    """Reference: adam_op.cc — bias-corrected via Beta1Pow/Beta2Pow state."""
    p, g = ctx.input("Param"), _dense_grad(ctx, "adam")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g.square()
    lr_t = _lr(ctx) * (1 - b2p).sqrt() / (1 - b1p)
    p_new = p - lr_t * m1n / (m2n.sqrt() + eps)
    _write(ctx, "Moment1", m1n)
    _write(ctx, "Moment2", m2n)
    _write(ctx, "Beta1Pow", b1p * b1)
    _write(ctx, "Beta2Pow", b2p * b2)
    _write(ctx, "Param", p_new)
