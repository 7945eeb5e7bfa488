"""Optimizer update op kernels (paddle_tpu/ops/optimizer_ops.py), with
`_write`/`_lr` (:20-31): sgd, momentum, adagrad, adadelta, rmsprop,
decayed_adagrad, adam, adamax, ftrl and proximal_gd, the learning-rate
schedule (`lr_schedule`), ModelAverage's `average_accumulate`, and the
static pruning hook's `prune_mask_init` and `apply_mask`.

The ops with a SelectedRows branch in the JAX file (sgd, momentum,
adagrad, adam) take the gradients of is_sparse embeddings: sgd adds the
rows' steps, the others update only the touched rows of the parameter and
its moments (lazy), their duplicates summed first, while Beta1Pow/Beta2Pow
still advance every step.

Each op replaces the parameter and its state persistables in the env; the
executor writes them back to the Scope after the run. The update makes new
tensors rather than updating in place, as the JAX package's does: the state
of the NMT model is 0.86 GB, so a second copy for one op costs little. The
state is f32, as the JAX package keeps it. No op reads the host on a dense
gradient: a step with any of them can be captured (core/graph.py).
"""

from __future__ import annotations

import torch

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


@register_op("adagrad")
def adagrad_kernel(ctx):
    """Reference: adagrad_op.cc — moment += g²; p -= lr·g/(√moment + ε);
    lazy on a SelectedRows gradient (untouched rows' moments stay)."""
    p, g, m = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    eps, lr = ctx.attr("epsilon", 1e-6), _lr(ctx)
    if isinstance(g, SelectedRows):
        rows, vals = g.dedup()
        m_rows = m[rows] + vals.square()
        _write(ctx, "Moment", m.index_copy(0, rows, m_rows))
        _write(ctx, "Param", p.index_add(0, rows, -lr * vals / (m_rows.sqrt() + eps)))
        return
    m_new = m + g.square()
    _write(ctx, "Moment", m_new)
    _write(ctx, "Param", p - lr * g / (m_new.sqrt() + eps))


@register_op("adadelta")
def adadelta_kernel(ctx):
    """Reference: adadelta_op.cc (its step takes no learning rate)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    avg_sq_g, avg_sq_u = ctx.input("AvgSquaredGrad"), ctx.input("AvgSquaredUpdate")
    rho, eps = ctx.attr("rho", 0.95), ctx.attr("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * g.square()
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    _write(ctx, "AvgSquaredGrad", g2)
    _write(ctx, "AvgSquaredUpdate", rho * avg_sq_u + (1 - rho) * update.square())
    _write(ctx, "Param", p + update)


@register_op("rmsprop")
def rmsprop_kernel(ctx):
    """Reference: rmsprop_op.cc, with its momentum term."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    rho, mu, eps = ctx.attr("decay", 0.9), ctx.attr("momentum", 0.0), ctx.attr("epsilon", 1e-6)
    ms_new = rho * ms + (1 - rho) * g.square()
    mom_new = mu * mom + _lr(ctx) * g / torch.sqrt(ms_new + eps)
    _write(ctx, "MeanSquare", ms_new)
    _write(ctx, "Moment", mom_new)
    _write(ctx, "Param", p - mom_new)


@register_op("decayed_adagrad")
def decayed_adagrad_kernel(ctx):
    """Reference: decayed_adagrad_op.cc."""
    p, g, m = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    decay, eps = ctx.attr("decay", 0.95), ctx.attr("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g.square()
    _write(ctx, "Moment", m_new)
    _write(ctx, "Param", p - _lr(ctx) * g / (m_new.sqrt() + eps))


@register_op("adamax")
def adamax_kernel(ctx):
    """Reference: adamax_op.cc."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, inf, b1p = ctx.input("Moment"), ctx.input("InfNorm"), ctx.input("Beta1Pow")
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, g.abs() + eps)
    _write(ctx, "Moment", m_new)
    _write(ctx, "InfNorm", inf_new)
    _write(ctx, "Beta1Pow", b1p * b1)
    _write(ctx, "Param", p - (_lr(ctx) / (1 - b1p)) * m_new / inf_new)


@register_op("ftrl")
def ftrl_kernel(ctx):
    """Reference: ftrl_op.cc."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    sq, lin = ctx.input("SquaredAccumulator"), ctx.input("LinearAccumulator")
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + g.square()
    if lr_power == -0.5:
        sigma = (new_sq.sqrt() - sq.sqrt()) / lr
        denom = new_sq.sqrt() / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
        denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    new_lin = lin + g - sigma * p
    pre_shrink = (l1 * torch.sign(new_lin) - new_lin) / denom
    _write(ctx, "SquaredAccumulator", new_sq)
    _write(ctx, "LinearAccumulator", new_lin)
    _write(ctx, "Param", torch.where(new_lin.abs() > l1, pre_shrink,
                                     torch.zeros((), dtype=pre_shrink.dtype,
                                                 device=pre_shrink.device)))


@register_op("proximal_gd")
def proximal_gd_kernel(ctx):
    """Reference: proximal_gd_op.cc — an l1/l2-regularized SGD step."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    lr = _lr(ctx)
    prox = p - lr * g
    _write(ctx, "Param", torch.sign(prox) * torch.clamp(prox.abs() - lr * l1, min=0.0)
           / (1.0 + lr * l2))


@register_op("average_accumulate")
def average_accumulate_kernel(ctx):
    """ModelAverage's sliding window (AverageOptimizer.h): the sum restarts
    from the parameter once the count would pass the window,
    clamp(rate · updates, min_window, max_window)."""
    p = ctx.input("Param")
    s, n, t = ctx.input("Sum"), ctx.input("Count"), ctx.input("Total")
    t_new = t + 1.0
    window = torch.clamp(ctx.attr("average_window", 0.15) * t_new,
                         ctx.attr("min_average_window", 10000),
                         ctx.attr("max_average_window", 10**9))
    restart = (n + 1.0) > window
    ctx.env[ctx.op.inputs["Sum"][0]] = torch.where(restart, p, s + p)
    ctx.env[ctx.op.inputs["Count"][0]] = torch.where(restart, torch.ones_like(n), n + 1.0)
    ctx.env[ctx.op.inputs["Total"][0]] = t_new


@register_op("lr_schedule")
def lr_schedule_kernel(ctx):
    """The scheduled learning rate from the step counter: the `schedule`
    attr (an optimizer.LRSchedule) computes it with torch operations on the
    step's device, with no host read."""
    ctx.set_output("Out", ctx.attr("schedule")(ctx.input("Step"), ctx.attr("base_lr")))


@register_op("prune_mask_init")
def prune_mask_init_kernel(ctx):
    """StaticPruningHook::generateMask (ParameterUpdaterHook.cpp:105): the
    mask zeroes exactly the round(ratio · n) smallest |w|, ties taken in
    index order (a stable sort, as jnp.argsort's)."""
    w = ctx.input("Param")
    flat = w.abs().reshape(-1)
    k = int(round(float(ctx.attr("sparsity_ratio", 0.8)) * flat.numel()))
    mask = torch.ones(flat.shape, dtype=w.dtype, device=w.device)
    if k > 0:
        mask[torch.argsort(flat, stable=True)[:k]] = 0
    ctx.set_output("Out", mask.reshape(w.shape))


@register_op("apply_mask")
def apply_mask_kernel(ctx):
    """StaticPruningHook::update (ParameterUpdaterHook.cpp:86): the mask
    applied again after every update."""
    _write(ctx, "Param", ctx.input("Param") * ctx.input("Mask"))
