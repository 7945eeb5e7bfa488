"""CTC (Connectionist Temporal Classification) ops (paddle_tpu/ops/ctc_ops.py):
the loss `warpctc` and the best-path decoder `ctc_greedy_decoder`.

`ctc_loss` is the JAX op's log-space alpha recursion over the
blank-extended labels [b, l1, b, l2, ..., b], the `lax.scan` over frames
as a Python loop over the T frames: within a frame nothing is read on the
host, masks go through `torch.where`, and an unreachable state holds the
same floor `_NEG = -1e30`, so an infeasible alignment gives the JAX value
and not inf, and a step with `warpctc` can be captured in a window. The
gradient is autograd's. Each frame's emission log-probabilities of all
extended symbols come from one product with the labels' one-hot rows before
the loop (exact, and its backward adds without atomics), where the JAX
op gathers them a frame at a time. `torch.nn.functional.ctc_loss` is not
used: the port computes what the JAX op computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.lod import LoDArray
from ..core.registry import register_op

_NEG = -1e30


def ctc_loss(logits_l: LoDArray, label_l: LoDArray, blank: int = 0, max_len=None,
             max_label_len=None, log_input: bool = False):
    """Each sequence's CTC negative log-likelihood [max_seqs] (0 for an
    absent or empty sequence). logits_l: LoD [*, C] frames, unnormalized
    unless log_input; label_l: LoD int tokens, none of them `blank`."""
    logit_tb, in_mask = logits_l.to_batch(max_len=max_len)  # [T, B, C]
    lbl = label_l.data
    if lbl.dim() == 2 and lbl.shape[1] == 1:
        lbl = lbl[:, 0]
    lbl_bt, _ = label_l.with_data(lbl.to(torch.int64)).to_batch(
        max_len=max_label_len, time_major=False)  # [B, L]
    B, L = lbl_bt.shape
    T, C = logit_tb.shape[0], logit_tb.shape[-1]
    dev = logit_tb.device
    logp = logit_tb if log_input else torch.log_softmax(logit_tb, -1)
    lab_lens = label_l.lengths.long()
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lbl_bt.clamp(0, C - 1)
    pos = torch.arange(S, device=dev)[None, :]
    valid_pos = pos < (2 * lab_lens[:, None] + 1)  # [B, S]
    # a skip from s-2 lands only on a label that differs from the one at s-2
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (pos % 2 == 1) & (ext != ext_m2)
    onehot = (ext[:, :, None] == torch.arange(C, device=dev)).to(logp.dtype)  # [B, S, C]
    emit = torch.einsum("tbc,bsc->tbs", logp, onehot)  # [T, B, S]
    # the state moves where the frame is real and the position valid;
    # elsewhere it keeps its value, which at an invalid position is _NEG
    moves = in_mask[:, :, None] & valid_pos[None]  # [T, B, S]
    neg = torch.full((), _NEG, dtype=logp.dtype, device=dev)
    has_label = lab_lens > 0
    alpha = emit[0, :, :1]
    if S > 1:
        alpha = torch.cat([alpha, torch.where(has_label, emit[0, :, 1], neg)[:, None],
                           neg.expand(B, S - 2)], 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        ap = torch.cat([pad2, alpha], 1)  # [B, S + 2]: alpha at s-2, s-1, s
        acc = torch.logaddexp(alpha, ap[:, 1:-1])
        acc = torch.where(can_skip, torch.logaddexp(acc, ap[:, :-2]), acc)
        alpha = torch.where(moves[t], acc + emit[t], alpha)
    # -log(alpha[2·len] + alpha[2·len - 1]): the final blank or the last label
    a_end = alpha.gather(1, (2 * lab_lens).clamp(max=S - 1)[:, None])[:, 0]
    a_prev = alpha.gather(1, (2 * lab_lens - 1).clamp(0, S - 1)[:, None])[:, 0]
    nll = -torch.logaddexp(a_end, torch.where(has_label, a_prev, neg))
    real = (torch.arange(B, device=dev) < logits_l.num_seqs) & (logits_l.lengths > 0)
    return torch.where(real, nll, torch.zeros_like(nll))


@register_op("ctc_greedy_decoder")
def ctc_greedy_decoder_kernel(ctx):
    """Best path (ctc_align_op.cc): each frame's argmax, repeats collapsed,
    blanks dropped. Ids [B, T] int32 padded with -1 and Lengths [B]: each
    kept frame's slot is the exclusive cumsum of the kept mask, scattered
    in one op."""
    logits: LoDArray = ctx.input("Logits")
    blank = ctx.attr("blank", 0)
    logit_tb, mask = logits.to_batch(max_len=ctx.attr("max_len"))
    pred = logit_tb.argmax(-1).to(torch.int32)  # [T, B], the first of equal maxima
    prev = F.pad(pred, (0, 0, 1, 0), value=-1)[:-1]
    keep = (pred != blank) & (pred != prev) & mask
    T, B = pred.shape
    k = keep.to(torch.int64)
    slot = torch.where(keep, torch.cumsum(k, 0) - k, torch.full_like(k, T))  # T: dropped
    out = torch.full((B, T + 1), -1, dtype=torch.int32, device=pred.device)
    out.scatter_(1, slot.T, torch.where(keep, pred, torch.full_like(pred, -1)).T)
    ctx.set_output("Ids", out[:, :T])
    ctx.set_output("Lengths", keep.sum(0).to(torch.int32))


@register_op("warpctc")
def warpctc_kernel(ctx):
    """warpctc_op.cc / WarpCTCLayer: each sequence's loss [max_seqs, 1];
    norm_by_times divides by the sequence's frame count."""
    logits: LoDArray = ctx.input("Logits")
    nll = ctc_loss(logits, ctx.input("Label"), blank=ctx.attr("blank", 0),
                   max_len=ctx.attr("max_len"), max_label_len=ctx.attr("max_label_len"))
    if ctx.attr("norm_by_times", False):
        nll = nll / logits.lengths.clamp(min=1).to(nll.dtype)
    ctx.set_output("Loss", nll[:, None])
