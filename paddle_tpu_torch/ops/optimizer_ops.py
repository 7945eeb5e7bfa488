"""Optimizer update op kernels: `sgd`, `momentum` and `adam`
(paddle_tpu/ops/optimizer_ops.py:34-45, 48-70, 139-171) with
`_write`/`_lr` (:20-31), dense and on SelectedRows gradients (is_sparse
embeddings): sgd adds the rows' steps, momentum and adam update only the
touched rows of the parameter and its moments (lazy), their duplicates
summed first, while Beta1Pow/Beta2Pow still advance every step.

Each op replaces the parameter and its state persistables in the env; the
executor writes them back to the Scope after the run. The update makes new
tensors rather than updating in place, as the JAX package's does: the state
of the NMT model is 0.86 GB, so a second copy for one op costs little."""

from __future__ import annotations

from ..core.registry import register_op
from ..core.sparse import SelectedRows


def _write(ctx, slot_in, value):
    """Write back through an in/out slot pair (ParamOut etc.)."""
    ctx.env[ctx.op.inputs[slot_in][0]] = value
    out_slot = slot_in + "Out"
    if ctx.has_output(out_slot):
        ctx.set_output(out_slot, value)


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


@register_op("sgd")
def sgd_kernel(ctx):
    """Reference: sgd_op.cc — p -= lr * g; a SelectedRows gradient adds its
    rows' steps (duplicates add, padding rows dropped)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    if isinstance(g, SelectedRows):
        rows, vals = g.dedup()
        _write(ctx, "Param", p.index_add(0, rows, (-_lr(ctx) * vals).to(p.dtype)))
        return
    _write(ctx, "Param", p - _lr(ctx) * g)


@register_op("momentum")
def momentum_kernel(ctx):
    """Reference: momentum_op.cc — v = mu·v + g; p -= lr·v, or with
    use_nesterov p -= (g + mu·v)·lr; lazy on a SelectedRows gradient."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    mu, lr = ctx.attr("mu", 0.9), _lr(ctx)
    if isinstance(g, SelectedRows):
        rows, vals = g.dedup()
        v_rows = mu * v[rows] + vals
        if ctx.attr("use_nesterov", False):
            step = -(vals + mu * v_rows) * lr
        else:
            step = -lr * v_rows
        _write(ctx, "Velocity", v.index_copy(0, rows, v_rows))
        _write(ctx, "Param", p.index_add(0, rows, step))
        return
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    _write(ctx, "Velocity", v_new)
    _write(ctx, "Param", p_new)


@register_op("adam")
def adam_kernel(ctx):
    """Reference: adam_op.cc — bias-corrected via Beta1Pow/Beta2Pow state;
    lazy on a SelectedRows gradient (its SelectedRows branch)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = _lr(ctx) * (1 - b2p).sqrt() / (1 - b1p)
    if isinstance(g, SelectedRows):
        rows, vals = g.dedup()
        m1r = b1 * m1[rows] + (1 - b1) * vals
        m2r = b2 * m2[rows] + (1 - b2) * vals.square()
        _write(ctx, "Moment1", m1.index_copy(0, rows, m1r))
        _write(ctx, "Moment2", m2.index_copy(0, rows, m2r))
        _write(ctx, "Param", p.index_add(0, rows, -lr_t * m1r / (m2r.sqrt() + eps)))
    else:
        m1n = b1 * m1 + (1 - b1) * g
        m2n = b2 * m2 + (1 - b2) * g.square()
        _write(ctx, "Moment1", m1n)
        _write(ctx, "Moment2", m2n)
        _write(ctx, "Param", p - lr_t * m1n / (m2n.sqrt() + eps))
    _write(ctx, "Beta1Pow", b1p * b1)
    _write(ctx, "Beta2Pow", b2p * b2)
