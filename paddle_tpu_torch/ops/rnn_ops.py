"""Recurrent op kernels: `dynamic_gru` (paddle_tpu/ops/rnn_ops.py:398-430)
with `gru_scan` (:126) and `gru_cell` (:103); `dynamic_lstm` (:352-395),
`stacked_lstm2` (:203-228) and `stacked_lstm` (:284-349) with `lstm_scan`
(:39), `stacked_lstm2_scan` (:162) and `stacked_lstm_book_scan` (:232);
`simple_rnn` (:432), a masked loop with no kernel. Packed gate layouts: GRU 3H [u(update),
r(reset), c(candidate)], LSTM 4H [i, f, g(candidate), o]. With the fused
flag on, the ops train through the hand-written kernels' autograd
Functions (rnn_kernels.gru_fused, lstm_kernels.lstm_fused) for the
standard gates; the scans train through plain autograd. The JAX package's
TPU eligibility rules (B a multiple of 8, H a multiple of 128 in a window)
do not carry over: a CUDA tensor goes to the kernel or the wrapper raises.

The scans compute in the io dtype op by op, as the JAX scans do: in bf16
the recurrent product is rounded before the add and the bias is added in
bf16, where the kernels add the unrounded f32 product to x. They are two
different bf16 functions."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op
from ..flags import FLAGS
from . import lstm_kernels, rnn_kernels
from .activation_ops import apply_activation, sigmoid
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


def lstm_scan(x_tbh, mask, w_rec, bias, w_peephole=None, h0=None, c0=None,
              gate_act="sigmoid", cell_act="tanh", cand_act="tanh", reverse=False):
    """Masked LSTM as a Python loop over T steps, with optional peepholes
    ([3H]: Wic, Wfc, Woc) and named activations. Returns
    (h_seq [T,B,H], (h_T, c_T))."""
    T, B, H4 = x_tbh.shape
    H = H4 // 4
    ga, ca, da = _act(gate_act), _act(cell_act), _act(cand_act)
    dt = x_tbh.dtype
    w_rec = w_rec.to(dt)
    bias = None if bias is None else bias.to(dt)
    dev = x_tbh.device
    h = torch.zeros(B, H, dtype=dt, device=dev) if h0 is None else h0.to(dt)
    c = torch.zeros(B, H, dtype=dt, device=dev) if c0 is None else c0.to(dt)
    w_ic = w_fc = w_oc = None
    if w_peephole is not None:
        w_ic, w_fc, w_oc = torch.chunk(w_peephole.to(dt), 3)
    h_seq = torch.empty(T, B, H, dtype=dt, device=dev)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_tbh[t] + dot(h, w_rec)
        if bias is not None:
            gates = gates + bias
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        if w_ic is not None:
            i = i + c * w_ic
            f = f + c * w_fc
        i, f = ga(i), ga(f)
        cn = f * c + i * da(g)
        if w_oc is not None:
            o = o + cn * w_oc
        hn = ga(o) * ca(cn)
        m = mask[t][:, None].to(dt)
        h = m * hn + (1 - m) * h
        c = m * cn + (1 - m) * c
        h_seq[t] = h
    return h_seq, (h, c)


def stacked_lstm2_scan(x_tbh, mask, w1, b1, wx2, w2, b2):
    """Two stacked LSTM layers in one masked loop: layer 2's input
    projection (h1 @ wx2) runs inside the step. Standard gates, forward.
    Returns (h2_seq [T,B,H], (h2_T, c2_T))."""
    T, B, H4 = x_tbh.shape
    H = H4 // 4
    dt = x_tbh.dtype
    w1, wx2, w2 = (w.to(dt) for w in (w1, wx2, w2))
    b1 = None if b1 is None else b1.to(dt)
    b2 = None if b2 is None else b2.to(dt)

    def cell(x_t, h_prev, c_prev, w, b, m):
        gates = x_t + dot(h_prev, w)
        if b is not None:
            gates = gates + b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = sigmoid(f) * c_prev + sigmoid(i) * torch.tanh(g)
        h = sigmoid(o) * torch.tanh(c)
        return m * h + (1 - m) * h_prev, m * c + (1 - m) * c_prev

    h1 = c1 = h2 = c2 = torch.zeros(B, H, dtype=dt, device=x_tbh.device)
    h2_seq = torch.empty(T, B, H, dtype=dt, device=x_tbh.device)
    for t in range(T):
        m = mask[t][:, None].to(dt)
        h1, c1 = cell(x_tbh[t], h1, c1, w1, b1, m)
        h2, c2 = cell(dot(h1, wx2), h2, c2, w2, b2, m)
        h2_seq[t] = h2
    return h2_seq, (h2, c2)


@register_op("stacked_lstm2")
def stacked_lstm2_kernel(ctx):
    """Two stacked LSTM layers with the inter-layer projection absorbed.
    With the fused flag on: the layer-1 kernel, one batched h1_seq @ wx2
    product, the layer-2 kernel. Off: the single two-layer scan."""
    x: LoDArray = ctx.input("Input")  # [*, 4H] pre-projected layer 1
    w1, wx2, w2 = (ctx.input(k) for k in ("Weight1", "WX2", "Weight2"))
    b1 = ctx.input("Bias1") if ctx.has_input("Bias1") else None
    b2 = ctx.input("Bias2") if ctx.has_input("Bias2") else None
    max_len = ctx.attr("max_len") or x.capacity
    x_tb, mask = x.to_batch(max_len=max_len)
    if FLAGS.use_fused_rnn:
        h1_seq, _ = lstm_kernels.lstm_fused(x_tb, mask, w1, bias=b1)
        h2_seq, _ = lstm_kernels.lstm_fused(dot(h1_seq, wx2), mask, w2, bias=b2)
    else:
        h2_seq, _ = stacked_lstm2_scan(x_tb, mask, w1, b1, wx2, w2, b2)
    ctx.set_output("Hidden", LoDArray.from_batch(h2_seq, mask, x))


def stacked_lstm_book_scan(x_tbh, mask, ws, bs, was, wbs, fbs):
    """N stacked LSTM layers in one masked loop with the book's
    inter-layer structure: layer i's gate input fc_i = [fc_{i-1} | h_{i-1}]
    @ [WA_i; WB_i] (+ bias), the concat-fc over [fc_prev, lstm_prev], one
    product accumulated in f32 and rounded once (the JAX scan's two f32
    products summed), computed inside the step. Standard gates, forward. Returns (fc_n_seq,
    h_n_seq): the book pools both streams."""
    T, B, H4 = x_tbh.shape
    H = H4 // 4
    n = len(ws)
    dt = x_tbh.dtype
    cast = lambda ts: [None if t is None else t.to(dt) for t in ts]  # noqa: E731
    ws, bs, fbs = cast(ws), cast(bs), cast(fbs)
    wabs = [torch.cat([wa, wb]).to(dt) for wa, wb in zip(was, wbs)]

    def cell(x_t, h_prev, c_prev, w, b, m):
        gates = x_t + dot(h_prev, w)
        if b is not None:
            gates = gates + b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = sigmoid(f) * c_prev + sigmoid(i) * torch.tanh(g)
        h = sigmoid(o) * torch.tanh(c)
        return m * h + (1 - m) * h_prev, m * c + (1 - m) * c_prev

    z = torch.zeros(B, H, dtype=dt, device=x_tbh.device)
    states = [(z, z)] * n
    fc_seq = torch.empty(T, B, H4, dtype=dt, device=x_tbh.device)
    h_seq = torch.empty(T, B, H, dtype=dt, device=x_tbh.device)
    for t in range(T):
        m = mask[t][:, None].to(dt)
        fc = x_tbh[t]
        for i in range(n):
            if i > 0:
                fc = dot(torch.cat([fc, states[i - 1][0]], -1), wabs[i - 1])
                if fbs[i - 1] is not None:
                    fc = fc + fbs[i - 1]
            states[i] = cell(fc, *states[i], ws[i], bs[i], m)
        fc_seq[t] = fc
        h_seq[t] = states[-1][0]
    return fc_seq, h_seq


@register_op("stacked_lstm")
def stacked_lstm_kernel(ctx):
    """N-layer book-structure stacked LSTM as one op. By default layer by
    layer: one lstm_kernels.lstm_fused a layer under the fused flag (else
    lstm_scan), the inter-layer concat-fc one batched product
    [fc_prev | h_prev] @ [WA; WB] over the whole [T, B, ·] sequence,
    accumulated in f32 and rounded once, as the JAX op sums its two f32
    products before rounding. Under FLAGS.stacked_lstm_single_scan, the
    all-layers loop stacked_lstm_book_scan.

    Inputs: Input (the layer-1 [*, 4H] projection), Weights (n of [H, 4H]),
    WAs (n-1 of [4H, 4H]: the fc_prev half of the inter-layer fc), WBs (n-1
    of [H, 4H]: the lstm_prev half), Biases (n of [4H]) and FcBiases (n-1
    of [4H]), both optional. Outputs: FcOut and Hidden."""
    x: LoDArray = ctx.input("Input")
    ws, was, wbs = ctx.inputs("Weights"), ctx.inputs("WAs"), ctx.inputs("WBs")
    n = len(ws)
    bs = ctx.inputs("Biases") if ctx.has_input("Biases") else [None] * n
    fbs = ctx.inputs("FcBiases") if ctx.has_input("FcBiases") else [None] * (n - 1)
    max_len = ctx.attr("max_len") or x.capacity
    x_tb, mask = x.to_batch(max_len=max_len)
    dt = x_tb.dtype
    if FLAGS.stacked_lstm_single_scan:
        fc_seq, h_seq = stacked_lstm_book_scan(x_tb, mask, ws, bs, was, wbs, fbs)
    else:
        fc_seq, h_seq = x_tb, None
        for i in range(n):
            if i > 0:
                fc_seq = dot(torch.cat([fc_seq, h_seq], -1), torch.cat([was[i - 1], wbs[i - 1]]))
                if fbs[i - 1] is not None:
                    fc_seq = fc_seq + fbs[i - 1].to(dt)
            if FLAGS.use_fused_rnn:
                h_seq, _ = lstm_kernels.lstm_fused(fc_seq, mask, ws[i], bias=bs[i])
            else:
                h_seq, _ = lstm_scan(fc_seq, mask, ws[i], bs[i])
    ctx.set_output("FcOut", LoDArray.from_batch(fc_seq, mask, x))
    ctx.set_output("Hidden", LoDArray.from_batch(h_seq, mask, x))


@register_op("dynamic_lstm")
def dynamic_lstm_kernel(ctx):
    """Input is the pre-projected [*, 4H] LoDArray. Peepholes, non-default
    activations and (off the fused flag) everything go to lstm_scan, as
    the reference's dispatch does; the rest to the kernels, reversed by
    their index walk."""
    x: LoDArray = ctx.input("Input")
    w = ctx.input("Weight")  # [H, 4H]
    b = ctx.input("Bias") if ctx.has_input("Bias") else None
    peep = None
    if b is not None and ctx.attr("use_peepholes", False):
        b, peep = b[: w.shape[1]], b[w.shape[1] :]
    max_len = ctx.attr("max_len") or x.capacity
    x_tb, mask = x.to_batch(max_len=max_len)
    acts = (ctx.attr("gate_activation", "sigmoid"), ctx.attr("cell_activation", "tanh"),
            ctx.attr("candidate_activation", "tanh"))
    reverse = ctx.attr("is_reverse", False)
    if FLAGS.use_fused_rnn and peep is None and acts == ("sigmoid", "tanh", "tanh"):
        h_seq, (h_T, c_T) = lstm_kernels.lstm_fused(x_tb, mask, w, bias=b, reverse=reverse)
    else:
        h_seq, (h_T, c_T) = lstm_scan(x_tb, mask, w, b, w_peephole=peep, gate_act=acts[0],
                                      cell_act=acts[1], cand_act=acts[2], reverse=reverse)
    ctx.set_output("Hidden", LoDArray.from_batch(h_seq, mask, x))
    if ctx.has_output("LastH"):
        ctx.set_output("LastH", h_T)
    if ctx.has_output("LastC"):
        ctx.set_output("LastC", c_T)


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


@register_op("simple_rnn")
def simple_rnn_kernel(ctx):
    """Gen-1 RecurrentLayer.cpp: h_t = act(x_t + h_{t-1} @ W (+ b)), a
    masked loop in the io dtype."""
    x: LoDArray = ctx.input("Input")
    w = ctx.input("Weight")  # [H, H]
    b = ctx.input("Bias") if ctx.has_input("Bias") else None
    act = _act(ctx.attr("activation", "tanh"))
    max_len = ctx.attr("max_len") or x.capacity
    x_tb, mask = x.to_batch(max_len=max_len)
    T, B, H = x_tb.shape[0], x_tb.shape[1], w.shape[0]
    dt = x_tb.dtype
    h = torch.zeros(B, H, dtype=dt, device=x_tb.device)
    h_seq = torch.empty(T, B, H, dtype=dt, device=x_tb.device)
    for t in range(T):
        hn = x_tb[t] + dot(h, w)
        if b is not None:
            hn = hn + b
        hn = act(hn)
        m = mask[t][:, None].to(dt)
        h = m * hn + (1 - m) * h
        h_seq[t] = h
    ctx.set_output("Hidden", LoDArray.from_batch(h_seq, mask, x))
    if ctx.has_output("LastH"):
        ctx.set_output("LastH", h)
