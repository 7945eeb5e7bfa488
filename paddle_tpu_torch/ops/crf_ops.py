"""Linear-chain CRF: the negative log-likelihood and Viterbi decoding
(paddle_tpu/ops/crf_ops.py: `crf_nll` :31, `crf_viterbi` :79, the
`linear_chain_crf` :109 and `crf_decoding` :122 ops), on torch tensors.

The transition parameter is [D+2, D]: row 0 the start weights, row 1 the
end weights, rows 2.. the tag-to-tag transitions (LinearChainCRF.cpp:23-32).
The ragged batch goes to dense [T, B, D] and a mask once; both recursions
then run as eager loops over T, each step a few small ops, where the JAX
package runs a `lax.scan`. A sequence's carry is frozen past its end. The
gradient comes from autograd through the log-sum-exp recursion, as the
JAX package takes it from `jax.grad`. Under amp these ops follow their
inputs' dtypes: bf16 emissions meet the f32 transition, so the recursions
run in f32 in both packages.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op


def _split(transition):
    return transition[0], transition[1], transition[2:]


def crf_nll(emission_l: LoDArray, label_l: LoDArray, transition, max_len=None):
    """The negative log-likelihood of each sequence's labels [max_seqs];
    the padded rows (past num_seqs) are 0. Labels are clipped to [0, D-1]."""
    D = emission_l.data.shape[-1]
    start_w, end_w, trans = _split(transition)
    emit_tb, mask = emission_l.to_batch(max_len=max_len)  # [T, B, D], [T, B]
    lbl = label_l.data
    if lbl.dim() == 2 and lbl.shape[1] == 1:
        lbl = lbl[:, 0]
    lbl_tb, _ = label_l.with_data(lbl.to(torch.int32)).to_batch(max_len=max_len)
    lbl_tb = lbl_tb.long().clamp(0, D - 1)
    T, B, _ = emit_tb.shape

    # the partition function: the alpha recursion, frozen past each end
    alpha = start_w[None, :] + emit_tb[0]  # [B, D]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + emit_tb[t]
        alpha = torch.where(mask[t][:, None], new, alpha)
    log_z = torch.logsumexp(alpha + end_w[None, :], dim=-1)

    # the gold path's score
    zero = torch.zeros((), dtype=emit_tb.dtype, device=emit_tb.device)
    emit_score = torch.gather(emit_tb, -1, lbl_tb[..., None])[..., 0]
    emit_sum = torch.where(mask, emit_score, zero).sum(0)  # [B]
    trans_score = trans[lbl_tb[:-1], lbl_tb[1:]]  # [T-1, B]
    trans_sum = torch.where(mask[1:], trans_score,
                            torch.zeros((), dtype=trans.dtype, device=trans.device)).sum(0)
    last_idx = (emission_l.lengths.long() - 1).clamp(0, T - 1)
    last_lbl = torch.gather(lbl_tb, 0, last_idx[None, :])[0]
    gold = emit_sum + trans_sum + start_w[lbl_tb[0]] + end_w[last_lbl]

    nll = log_z - gold
    valid = torch.arange(B, device=nll.device) < emission_l.num_seqs
    return torch.where(valid, nll, torch.zeros((), dtype=nll.dtype, device=nll.device))


def crf_viterbi(emission_l: LoDArray, transition, max_len=None):
    """The best tag path, dense [T, B] int32, and the batch mask [T, B].
    A frozen step's backpointers are the identity, so backtracking through
    a sequence's padding keeps its last tag. Ties go to the lowest tag
    (torch.argmax and jnp.argmax both take the first maximum)."""
    start_w, end_w, trans = _split(transition)
    emit_tb, mask = emission_l.to_batch(max_len=max_len)
    T, B, D = emit_tb.shape
    ident = torch.arange(D, device=emit_tb.device).expand(B, D)
    alpha = start_w[None, :] + emit_tb[0]
    bps = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None]  # [B, D_prev, D]
        best_prev = torch.argmax(scores, dim=1)  # [B, D]
        new = scores.amax(dim=1) + emit_tb[t]
        m_t = mask[t][:, None]
        alpha = torch.where(m_t, new, alpha)
        bps.append(torch.where(m_t, best_prev, ident))
    tag = torch.argmax(alpha + end_w[None, :], dim=-1)
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    return torch.stack(tags[::-1]).to(torch.int32), mask


@register_op("linear_chain_crf")
def linear_chain_crf_kernel(ctx):
    """LogLikelihood [max_seqs, 1]: the NEGATIVE log-likelihood of each
    sequence, as linear_chain_crf_op.cc's output, which the book's model
    feeds to mean()."""
    nll = crf_nll(ctx.input("Emission"), ctx.input("Label"), ctx.input("Transition"),
                  max_len=ctx.attr("max_len"))
    ctx.set_output("LogLikelihood", nll[:, None])


@register_op("crf_decoding")
def crf_decoding_kernel(ctx):
    """The Viterbi path (crf_decoding_op.cc): without Label, the decoded
    tag of each token (int32, the emission's LoD); with Label, 1 where the
    tag equals the label and 0 elsewhere, padding 0. It gives the
    transition no gradient. Where nothing of the run reads its output (the
    training program, whose decoding only the for-test clone fetches), it
    computes nothing, as XLA drops the JAX op's dead output."""
    if not ctx.output_read("ViterbiPath"):
        return
    emission: LoDArray = ctx.input("Emission")
    with torch.no_grad():
        tags, mask = crf_viterbi(emission, ctx.input("Transition"),
                                 max_len=ctx.attr("max_len"))
        tags_lod = LoDArray.from_batch(tags[..., None], mask, emission)
        if ctx.has_input("Label"):
            lbl = ctx.input("Label").data
            if lbl.dim() == 1:
                lbl = lbl[:, None]
            correct = (tags_lod.data == lbl.to(torch.int32)).to(torch.int32)
            correct = torch.where(emission.token_mask[:, None], correct,
                                  torch.zeros((), dtype=torch.int32, device=correct.device))
            ctx.set_output("ViterbiPath", emission.with_data(correct))
        else:
            ctx.set_output("ViterbiPath", tags_lod)
