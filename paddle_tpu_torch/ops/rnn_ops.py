"""Recurrent op kernels: `dynamic_gru` (paddle_tpu/ops/rnn_ops.py:398-430)
with `gru_scan` (:126) and `gru_cell` (:103). Packed GRU gate layout in the
3H weight/bias: [u(update), r(reset), c(candidate)]. With the fused flag on
the op trains through the hand-written kernels' autograd Function
(rnn_kernels.gru_fused); gru_scan trains through plain autograd."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op
from ..flags import FLAGS
from . import rnn_kernels
from .activation_ops import apply_activation
from .math_ops import dot


def _act(name):
    return lambda v: apply_activation(v, name or "identity")


def gru_cell(xp, h_prev, w_rec, ga, da):
    """One GRU step on a pre-projected (and biased) input xp [..., 3H]:
    h = (1-u)*h_prev + u*c, in xp's dtype. Shared by gru_scan and the
    beam-search decoder."""
    H = h_prev.shape[-1]
    w_ur, w_c = w_rec[:, : 2 * H], w_rec[:, 2 * H :]
    x_ur, x_c = xp[..., : 2 * H], xp[..., 2 * H :]
    ur = ga(x_ur + dot(h_prev, w_ur).to(xp.dtype))
    u, r = ur[..., :H], ur[..., H:]
    c = da(x_c + dot(r * h_prev, w_c).to(xp.dtype))
    return (1 - u) * h_prev + u * c


def gru_scan(x_tbh, mask, w_rec, bias, h0=None, gate_act="sigmoid",
             cand_act="tanh", reverse=False):
    """Masked GRU as a Python loop over T steps of gru_cell."""
    T, B, H3 = x_tbh.shape
    H = H3 // 3
    ga, da = _act(gate_act), _act(cand_act)
    dt = x_tbh.dtype
    w_rec = w_rec.to(dt)
    bias = None if bias is None else bias.to(dt)
    h = torch.zeros(B, H, dtype=dt, device=x_tbh.device) if h0 is None else h0.to(dt)
    h_seq = torch.empty(T, B, H, dtype=dt, device=x_tbh.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        x_t = x_tbh[t] if bias is None else x_tbh[t] + bias
        hn = gru_cell(x_t, h, w_rec, ga, da)
        m = mask[t][:, None].to(dt)
        h = m * hn + (1 - m) * h
        h_seq[t] = h
    return h_seq, h


@register_op("dynamic_gru")
def dynamic_gru_kernel(ctx):
    x: LoDArray = ctx.input("Input")
    w = ctx.input("Weight")  # [H, 3H]
    b = ctx.input("Bias") if ctx.has_input("Bias") else None
    max_len = ctx.attr("max_len") or x.capacity
    x_tb, mask = x.to_batch(max_len=max_len)
    gate_act = ctx.attr("gate_activation", "sigmoid")
    cand_act = ctx.attr("candidate_activation", "tanh")
    reverse = ctx.attr("is_reverse", False)
    if FLAGS.use_fused_rnn and gate_act == "sigmoid" and cand_act == "tanh":
        h_seq, h_T = rnn_kernels.gru_fused(x_tb, mask, w, b, reverse=reverse)
    else:
        h_seq, h_T = gru_scan(x_tb, mask, w, b, gate_act=gate_act,
                              cand_act=cand_act, reverse=reverse)
    ctx.set_output("Hidden", LoDArray.from_batch(h_seq, mask, x))
    if ctx.has_output("LastH"):
        ctx.set_output("LastH", h_T)
