"""The Bahdanau-attention GRU decoder ops (paddle_tpu/ops/attention_ops.py):
`attention_gru_decoder` (:56-129), the training-time decoder under teacher
forcing, `attention_gru_beam_search` (:132-211), and their `_attention`
(:36).

The training decoder takes the hand-written attention kernels under their
own backward (ops/attention_kernels.py) while FLAGS.use_fused_attention is
on, and on CUDA always does: the TPU's eligibility rules (A and C multiples
of 128, a batch tile, S padded to 16) do not carry over. Off, it runs the
scan formulation as a Python loop with plain autograd.

The JAX package runs beam search as one lax.scan with no Pallas kernel;
here it is a Python loop over `max_len` steps in plain PyTorch, each step
allocating its [B,K,S,A] attention and [B,K,V] logits anew. Static [B,K]
beam state and a (parent, token) trellis backtracked at the end.
"""

from __future__ import annotations

import torch

from .. import amp
from ..core.lod import LoDArray
from ..core.registry import register_op
from ..flags import FLAGS
from . import attention_kernels, beam_common
from .activation_ops import sigmoid, softmax
from .math_ops import dot
from .rnn_ops import gru_cell


def _attention(h, enc, enc_proj, enc_mask, w_dec, v_att):
    """Bahdanau attention: h [B,H] → context [B,C], or for beams h [B,K,H]
    → [B,K,C]. enc [B,S,C], enc_proj [B,S,A] (enc @ WaEnc), enc_mask [B,S]
    bool; score(s_j, h) = v · tanh(enc_proj_j + W_dec h)."""
    dec_proj = dot(h, w_dec)
    neg = torch.full((), -1e9, dtype=h.dtype, device=h.device)
    if h.dim() == 2:
        t = torch.tanh(enc_proj + dec_proj[:, None, :])  # [B,S,A]
        scores = torch.where(enc_mask, dot(t, v_att), neg)
        return torch.einsum("bs,bsc->bc", softmax(scores), enc)
    t = torch.tanh(enc_proj[:, None] + dec_proj[:, :, None, :])  # [B,K,S,A]
    scores = dot(t, v_att)  # [B,K,S]
    scores = torch.where(enc_mask[:, None], scores, neg)
    return torch.matmul(softmax(scores), enc)  # [B,K,C]


@register_op("attention_gru_decoder")
def attention_gru_decoder_kernel(ctx):
    """Training-time attention decoder (teacher forcing).

    Inputs: EncState LoDArray [.., C], TrgEmb LoDArray [.., E], H0 [B,H],
    WaEnc [C,A], WaDec [H,A], Va [A], Wx [(E+C),3H], Wh [H,3H], Bias [3H].
    Attrs: src_max_len, trg_max_len. Output: Hidden LoDArray [.., H]
    aligned with TrgEmb's lod."""
    enc_l: LoDArray = ctx.input("EncState")
    trg_l: LoDArray = ctx.input("TrgEmb")
    h0 = ctx.input("H0")
    wa_enc, wa_dec, v_att = ctx.input("WaEnc"), ctx.input("WaDec"), ctx.input("Va")
    wx, wh = ctx.input("Wx"), ctx.input("Wh")
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None

    src_len = ctx.attr("src_max_len") or enc_l.capacity
    trg_len = ctx.attr("trg_max_len") or trg_l.capacity
    enc_b, enc_mask = enc_l.to_batch(max_len=src_len, time_major=False)  # [B,S,C]
    trg_b, trg_mask = trg_l.to_batch(max_len=trg_len)  # [T,B,E]
    # the embedding gather emits f32; under amp it casts down like a mul's
    # input, or it would pin the whole decoder to f32 (ROADMAP A4)
    trg_b = amp.cast_inputs(ctx, trg_b)
    # one compute dtype: f32 masters cast down to the activations' dtype
    dt = trg_b.dtype
    wa_enc, wa_dec, v_att = (w.to(dt) for w in (wa_enc, wa_dec, v_att))
    wx, wh = wx.to(dt), wh.to(dt)
    bias = None if bias is None else bias.to(dt)
    h0, enc_b = h0.to(dt), enc_b.to(dt)
    enc_proj = dot(enc_b, wa_enc)  # [B,S,A], outside the kernels

    if FLAGS.use_fused_attention:
        h_seq = attention_kernels.fused_attention_decoder(
            enc_b, enc_proj, enc_mask, trg_b, trg_mask, h0, wa_dec, v_att, wx, wh, bias)
    else:
        h, steps = h0, []
        for t in range(trg_b.shape[0]):
            ctxv = _attention(h, enc_b, enc_proj, enc_mask, wa_dec, v_att)
            xp = dot(torch.cat([trg_b[t], ctxv], dim=-1), wx)
            if bias is not None:
                xp = xp + bias
            hn = gru_cell(xp, h, wh, sigmoid, torch.tanh)
            m = trg_mask[t][:, None].to(dt)
            h = m * hn + (1 - m) * h
            steps.append(h)
        h_seq = torch.stack(steps)
    ctx.set_output("Hidden", LoDArray.from_batch(h_seq, trg_mask, trg_l))


@register_op("attention_gru_beam_search")
def attention_gru_beam_search_kernel(ctx):
    """Inputs: EncState (LoDArray), H0 [B,H], WaEnc [C,A], WaDec [H,A],
    Va [A], Wx [(E+C),3H], Wh [H,3H], Bias [3H], Embedding [V,E],
    WOut [H,V], BOut [V]. Attrs: beam_size, max_len, bos_id, eos_id,
    src_max_len, length_normalize.
    Outputs: Ids [B,K,T] int32, Scores [B,K] (best first), Lengths [B,K]
    int32 (tokens up to and including the first EOS)."""
    enc_l: LoDArray = ctx.input("EncState")
    h0 = ctx.input("H0")
    wa_enc, wa_dec, v_att = ctx.input("WaEnc"), ctx.input("WaDec"), ctx.input("Va")
    wx, wh = ctx.input("Wx"), ctx.input("Wh")
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None
    emb = ctx.input("Embedding")
    w_out, b_out = ctx.input("WOut"), ctx.input("BOut")

    K = ctx.attr("beam_size", 4)
    T = ctx.attr("max_len", 32)
    bos = ctx.attr("bos_id", 0)
    eos = ctx.attr("eos_id", 1)
    src_len = ctx.attr("src_max_len") or enc_l.capacity
    norm_by_len = ctx.attr("length_normalize", False)

    enc_b, enc_mask = enc_l.to_batch(max_len=src_len, time_major=False)
    dt = enc_b.dtype  # uniform dtype under amp: f32 masters cast down
    wa_enc, wa_dec, v_att = (p.to(dt) for p in (wa_enc, wa_dec, v_att))
    wx, wh = wx.to(dt), wh.to(dt)
    bias = None if bias is None else bias.to(dt)
    emb, w_out, b_out = emb.to(dt), w_out.to(dt), b_out.to(dt)
    h0 = h0.to(dt)
    enc_proj = dot(enc_b, wa_enc)  # [B,S,A]
    B = enc_b.shape[0]
    dev = enc_b.device

    h = h0[:, None].expand(B, K, h0.shape[-1])
    tok = torch.full((B, K), bos, dtype=torch.int32, device=dev)
    sc = beam_common.init_scores(B, K, dt, dev)
    fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
    parents, toks = [], []
    for _ in range(T):
        x = emb[tok.long()]  # [B,K,E]
        ctxv = _attention(h, enc_b, enc_proj, enc_mask, wa_dec, v_att)
        xp = dot(torch.cat([x, ctxv], dim=-1), wx)
        if bias is not None:
            xp = xp + bias
        h_new = gru_cell(xp, h, wh, sigmoid, torch.tanh)
        h_new = torch.where(fin[..., None], h, h_new)
        logits = dot(h_new, w_out) + b_out  # [B,K,V]
        logp = torch.log_softmax(logits, dim=-1)
        logp = beam_common.freeze_finished(logp, fin, eos)
        sc, parent, tok = beam_common.expand_prune(sc, logp, K)
        h = torch.gather(h_new, 1, parent[..., None].expand_as(h_new))
        fin = torch.gather(fin, 1, parent) | (tok == eos)
        parents.append(parent)
        toks.append(tok)
    ids = beam_common.backtrack(parents, toks, B, K)
    ids, out_scores, lengths = beam_common.finalize(ids, sc, eos, T, norm_by_len)

    ctx.set_output("Ids", ids)
    ctx.set_output("Scores", out_scores)
    if ctx.has_output("Lengths"):
        ctx.set_output("Lengths", lengths)
