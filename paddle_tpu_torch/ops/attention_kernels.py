"""Bahdanau attention decoder for training: the hand-written Hopper kernels
(csrc/bahdanau_attn.cu, csrc/decoder_seq.cu), their plain PyTorch versions,
and `fused_attention_decoder`, the autograd Function around them.

The counterpart of paddle_tpu/ops/bahdanau_kernels.py. Its default is the
per-step (scan) formulation:

  attn_fwd       replaces `_attn_fwd_kernel` / `_attn_fwd` (:170,257): one
                 decoder step's scores Σ_A tanh(ep+dp)·v, the masked softmax
                 over S and ctx = α·enc, never materialising [B,S,A]. In
                 bf16 on staged rows of the valid positions (csrc/attn_row.cuh,
                 by the bulk-copy engine or plain loads: `attn_fwd_path`).
  attn_bwd_step  replaces `_attn_bwd_kernel` / `_attn_bwd_step` (:190,285):
                 dα = dctx·enc, the softmax backward dsc, and
                 ddp = Σ_S dsc·(1-t²)·v from a recomputed tanh. In bf16
                 on a cluster of CTAs a row that splits the row's listed
                 positions (csrc/attn_row.cuh `attend_bwd`:
                 `attn_bwd_path`, `attn_bwd_cluster`); a row whose dctx is
                 all zero, or with no valid position, reads nothing.
  attn_phase2    replaces `_attn_phase2_kernel` / `_attn_phase2` (:217,315):
                 d(enc_proj) [B,S,A] summed in f32 over all T steps and
                 written once, and dv [A] in f32, on a walk over the
                 terms with a nonzero dsc, in both io dtypes, up to
                 DEP_MAX_S source positions; the whole-sequence backward's
                 pass (`decoder_seq_dep`) runs the same kernel with t
                 newest first.

With FLAGS.fused_attention_seq_fwd and fused_attention_seq_bwd (off by
default, as in the JAX package) the decoder runs whole-sequence kernels
instead, one launch each a step:

  decoder_seq_fwd  replaces `_decoder_seq_kernel` / `_decoder_seq_fwd`
                   (:347,399): all T steps of dp = h·wa_dec (f32, not
                   rounded), the attention, xp = io(xpx_t + io(ctx·wx_c)) and
                   the GRU cell, h carried on chip.
  decoder_seq_bwd  replaces `_decoder_seq_bwd_kernel` / `_decoder_seq_bwd`
                   (:460,568): the T reverse steps of the GRU cell's
                   backward, the attention's backward and the d(enc_proj)/dv
                   accumulation, dh carried in f32.

Those two are bound by their T dependent steps (four barriers a step),
not by bytes or operations; csrc/decoder_seq.cu says what its design does
about it. In bf16 both run on the tensor cores on the GRU kernels'
partition (16 hidden units by 32-row batch sub-tiles a CTA, plus a slice
of C (backward) or of A (forward) and the attention of some of its group's
rows). The forward's weights are padded by `seq_fwd_weights`, its plan is
`decoder_seq_fwd_plan`, and `seq_fwd_route` sends a shape the plan cannot
place to the first design, before any launch. The backward's weights are
padded by `seq_bwd_weights`, its plan is `decoder_seq_bwd_plan`; it writes
dsc [T,B,S], and `decoder_seq_dep` then sums d(enc_proj) and dv off the
recurrence, in the plain version's order. The
per-step kernels read [B,S,A] and [B,S,C] once
per call and compute little on each byte, so bytes bound them. The S axis
is not padded: the TPU pads it to a multiple of 16 for its tiles
(tune/space.py:39-43), and a padded slot carries a -1e9 score, so it
changes nothing but the tile.

Each wrapper takes CUDA tensors to its kernel, or raises; CPU tensors to
its plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..flags import FLAGS
from . import cuda_build
from .activation_ops import sigmoid
from .lstm_kernels import pad_w_bwd
from .rnn_ops import gru_cell

# the routes of attn_fwd and attn_bwd_step and of the whole-sequence
# forward (see attn_fwd_path, attn_bwd_path and seq_fwd_route)
ATTN_BULK, ATTN_LOADS, FIRST = "bulk", "loads", "first"
SEQ_TC = "tc"

# launches of the CUDA kernels in this process, in all and by route;
# chip_smoke.py reads them
attn_fwd_launches = 0
attn_fwd_paths = {ATTN_BULK: 0, ATTN_LOADS: 0, FIRST: 0}
attn_bwd_step_launches = 0
attn_bwd_step_paths = {ATTN_BULK: 0, ATTN_LOADS: 0, FIRST: 0}
attn_phase2_launches = 0
decoder_seq_fwd_launches = 0
decoder_seq_fwd_routes = {SEQ_TC: 0, FIRST: 0}
decoder_seq_bwd_launches = 0
decoder_seq_dep_launches = 0

# the bf16 kernels' partition (tcb:: in csrc/decoder_seq.cu): hidden units
# and batch rows of a sub-tile a CTA, the most columns of C a backward CTA
# takes and of A a forward CTA takes
SEQ_UNITS, SEQ_ROWS, SEQ_MAX_SLICE, SEQ_MAX_AS = 16, 32, 128, 64
# the forward's products' ring (3 chunks of 2 slots of 32 rows of 72 bf16),
# its attention's stage at least; a sub-tile's state (5 floats a pair)
SEQ_RING_BYTES, SEQ_FSTATE_BYTES = 3 * 2 * 32 * 72 * 2, 5 * 32 * 16 * 4
# csrc/attn_row.cuh: the most ctx (or ddp) columns of its 256 threads (8
# x 4 groups a thread), its least stage; B5's stage (two CTAs an SM) and
# B6's (four CTAs an SM at A up to 2048); the most ranks of B6's cluster,
# and the source positions a rank takes at most by attn_bwd_cluster's rule
ROW_MAX_C, ROW_MIN_STAGE, ATTN_ROW_STAGE, ATTN_BWD_STAGE = 8 * 4 * 256, 8192, 96 * 1024, 45 * 1024
ATTN_MAX_CLUSTER, ATTN_RANK_POSITIONS = 4, 32
# B7's walk (attn_dep_kernel): source positions and columns of A a CTA, and
# the most positions a row (its order of them in shared memory)
DEP_POSITIONS, DEP_COLUMNS, DEP_MAX_S = 16, 256, 16384
# the card the rules are stated for: an H100's (or H200's) SMs and the
# shared memory a block may opt in to. chip_smoke.py holds each rule to the
# card's own plan.
CARD_SMS, CARD_SMEM = 132, 232448

_IO_DTYPES = (torch.float32, torch.bfloat16)
_NEG = -1e9


# ------------------------------------------------------------ plain versions --
def attn_fwd_plain(ep, enc, dp, v, mask):
    """ep [B,S,A], enc [B,S,C], dp [B,A], v [A] in the io dtype; mask [B,S]
    (>0 on real source tokens). Scores and softmax in f32; ctx is α (rounded
    to the io dtype) times enc, summed in f32. Returns (ctx [B,C] io dtype,
    alpha [B,S] f32)."""
    t = torch.tanh(ep.float() + dp.float()[:, None, :])
    scores = (t * v.float()).sum(-1)
    scores = torch.where(mask > 0, scores, torch.full((), _NEG, device=ep.device))
    e = torch.exp(scores - scores.max(-1, keepdim=True).values)
    alpha = e / e.sum(-1, keepdim=True)
    ctx = torch.bmm(alpha.to(enc.dtype).float()[:, None, :], enc.float())[:, 0]
    return ctx.to(enc.dtype), alpha


def attn_bwd_step_plain(ep, enc, dp, v, mask, dctx, alpha):
    """One step's attention backward. dctx [B,C] io dtype, alpha [B,S] f32
    (attn_fwd's). Returns (ddp [B,A] io dtype, dsc [B,S] f32, masked to 0)."""
    dalpha = torch.bmm(enc.float(), dctx.float()[:, :, None])[..., 0]
    tot = (alpha * dalpha).sum(-1, keepdim=True)
    dsc = alpha * (dalpha - tot)
    dsc = torch.where(mask > 0, dsc, torch.zeros((), device=dsc.device))
    t = torch.tanh(ep.float() + dp.float()[:, None, :])
    ddp = torch.bmm(dsc[:, None, :], 1.0 - t * t)[:, 0] * v.float()
    return ddp.to(ep.dtype), dsc


def attn_phase2_plain(ep, dp_seq, dsc_seq, v):
    """dep[b,s,a] = Σ_t dsc·(1-tanh(ep+dp_t)²)·v, summed in f32 over t in
    order and rounded once to the io dtype; dv[a] = Σ_{t,b,s} tanh·dsc in
    f32. dp_seq [T,B,A] io dtype, dsc_seq [T,B,S] f32. Returns (dep [B,S,A],
    dv [A] f32)."""
    epf, vf = ep.float(), v.float()
    dep = torch.zeros_like(epf)
    dv = torch.zeros_like(vf)
    for t in range(dp_seq.shape[0]):
        th = torch.tanh(epf + dp_seq[t].float()[:, None, :])
        dsc = dsc_seq[t][:, :, None]
        dep = dep + dsc * (1.0 - th * th) * vf
        dv = dv + (th * dsc).sum((0, 1))
    return dep.to(ep.dtype), dv


def decoder_seq_dep_plain(ep, dp_seq, dsc_seq, v):
    """The backward's d(enc_proj) and dv from the walk's dsc, as
    decoder_seq_bwd_plain sums them: dep[b,s,a] = Σ_t (dsc·(1-th²))·v over t
    from newest to oldest, th = tanh(ep + dp_t), summed in f32 and rounded
    once to the io dtype; dv[a] = Σ_t Σ_{b,s} th·dsc in f32, newest first.
    dp_seq [T,B,A] io dtype, dsc_seq [T,B,S] f32. Returns (dep [B,S,A], dv
    [A] f32)."""
    epf, vf = ep.float(), v.float()
    dep = torch.zeros_like(epf)
    dv = torch.zeros_like(vf)
    for t in range(dp_seq.shape[0] - 1, -1, -1):
        th = torch.tanh(epf + dp_seq[t].float()[:, None, :])
        term = dsc_seq[t][:, :, None] * (1.0 - th * th)
        dep = dep + term * vf
        dv = dv + (th * dsc_seq[t][:, :, None]).sum((0, 1))
    return dep.to(ep.dtype), dv


def _mm(a, b):
    """a @ b summed in f32, from operands already in the io dtype: the
    kernels' products (and the JAX kernels' preferred_element_type=f32)."""
    return torch.matmul(a.float(), b.float())


def decoder_seq_fwd_plain(ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c):
    """All T steps of the decoder's forward, with the whole-sequence
    kernel's roundings (which are not the scan's): dp = h·wa_dec kept in f32,
    and xp = io(xpx_t + io(ctx·wx_c)) rounded twice where the scan rounds
    the product of [trg, ctx] once. ep [B,S,A], enc [B,S,C], xpx [T,B,3H]
    (trg·wx[:E] + bias), h0 [B,H], wa_dec [H,A], v [A], wx_c [C,3H], w_ur
    [H,2H], w_c [H,H] in the io dtype; mask [B,S] and tmask [T,B] f32. The
    GRU cell runs in the io dtype (`gru_cell`, the op-by-op sigmoid).
    Returns (h_seq [T,B,H], alpha [T,B,S] f32, ctx [T,B,C])."""
    dt = h0.dtype
    epf, encf, vf = ep.float(), enc.float(), v.float()
    wh = torch.cat([w_ur, w_c], -1)
    neg = torch.full((), _NEG, device=ep.device)
    h, hs, alphas, ctxs = h0, [], [], []
    for t in range(xpx.shape[0]):
        dp = _mm(h, wa_dec)
        scores = (torch.tanh(epf + dp[:, None, :]) * vf).sum(-1)
        scores = torch.where(mask > 0, scores, neg)
        e = torch.exp(scores - scores.max(-1, keepdim=True).values)
        alpha = e / e.sum(-1, keepdim=True)
        ctx = torch.bmm(alpha.to(dt).float()[:, None, :], encf)[:, 0].to(dt)
        xp = xpx[t] + _mm(ctx, wx_c).to(dt)
        hn = gru_cell(xp, h, wh, sigmoid, torch.tanh)
        m = tmask[t][:, None].to(dt)
        h = m * hn + (1 - m) * h
        hs.append(h)
        alphas.append(alpha)
        ctxs.append(ctx)
    return torch.stack(hs), torch.stack(alphas), torch.stack(ctxs)


def decoder_seq_bwd_plain(ep, enc, mask, g_seq, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq,
                          alpha_seq, v, w_c, w_ur, wx_c, wa_dec):
    """The decoder's backward over all T steps, newest first, with the
    whole-sequence kernel's arithmetic: dh carried in f32, each product's
    left operand rounded to the io dtype and summed in f32, d(enc_proj)
    summed in f32 over t from newest to oldest and rounded once, dv in f32.
    g_seq, hp_seq, u_seq, r_seq, c_seq [T,B,H] and dp_seq [T,B,A] in the io
    dtype (the batched recompute), alpha_seq [T,B,S] f32, the rest as
    decoder_seq_fwd_plain's. Returns (dxp [T,B,3H], dctx [T,B,C], ddp
    [T,B,A], dh0 [B,H], dep [B,S,A], dv [A] f32)."""
    dt = hp_seq.dtype
    T = hp_seq.shape[0]
    epf, encf, vf = ep.float(), enc.float(), v.float()
    dh = torch.zeros(hp_seq.shape[1:], device=ep.device)
    dep = torch.zeros_like(epf)
    dv = torch.zeros_like(vf)
    dxps, dctxs, ddps = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        hp, u, r, c = (x[t].float() for x in (hp_seq, u_seq, r_seq, c_seq))
        m = tmask[t][:, None]
        dh = dh + g_seq[t].float()
        dh_cell = dh * m
        dh_prev = dh * (1.0 - m)
        du = dh_cell * (c - hp)
        dc = dh_cell * u
        dh_prev = dh_prev + dh_cell * (1.0 - u)
        dpre_c = dc * (1.0 - c * c)
        drh = _mm(dpre_c.to(dt), w_c.T)
        dr = drh * hp
        dh_prev = dh_prev + drh * r
        dur = torch.cat([du * u * (1.0 - u), dr * r * (1.0 - r)], -1)
        dh_prev = dh_prev + _mm(dur.to(dt), w_ur.T)
        dxp = torch.cat([dur, dpre_c], -1).to(dt)
        dctx = _mm(dxp, wx_c.T).to(dt)
        dalpha = torch.bmm(encf, dctx.float()[:, :, None])[..., 0]
        alpha = alpha_seq[t]
        dsc = alpha * (dalpha - (alpha * dalpha).sum(-1, keepdim=True))
        dsc = torch.where(mask > 0, dsc, torch.zeros((), device=dsc.device))
        th = torch.tanh(epf + dp_seq[t].float()[:, None, :])
        term = dsc[:, :, None] * (1.0 - th * th)
        ddp = (term.sum(1) * vf).to(dt)
        dh = dh_prev + _mm(ddp, wa_dec.T)
        dep = dep + term * vf
        dv = dv + (th * dsc[:, :, None]).sum((0, 1))
        dxps[t], dctxs[t], ddps[t] = dxp, dctx, ddp
    return (torch.stack(dxps), torch.stack(dctxs), torch.stack(ddps), dh.to(dt), dep.to(ep.dtype),
            dv)


# ------------------------------------------------------------- the routes --
def _pad8(n):
    return -(-n // 8) * 8


def row_fixed_bytes(S, A):
    """csrc/attn_row.cuh's fixed_bytes: the mbarriers and the list's length
    (32 bytes), dp and v [pad8(A)] and the scores and the list [S], 4 bytes
    each, rounded up to 16."""
    return -(-(32 + 8 * _pad8(A) + 8 * S) // 16) * 16


def row_bwd_fixed_bytes(S, A, C, ranks):
    """attn_row::bwd_fixed_bytes on `ranks` ranks: row_fixed_bytes, then
    dctx [pad8(C)], α [S], dα [S], the Σα·dα slots [ATTN_MAX_CLUSTER] and
    rank 0's receive buffer [ranks - 1][pad8(A)] f32, rounded up to 16."""
    words = _pad8(C) + 2 * S + ATTN_MAX_CLUSTER + (ranks - 1) * _pad8(A)
    return row_fixed_bytes(S, A) + -(-(4 * words) // 16) * 16


def row_stage_fits(A, C, stage_bytes):
    """attn_row::stage_fits: either half of the stage holds one position's
    row of ep and of enc (padded to 8 elements), and the stage the ctx
    classes' sums."""
    half = stage_bytes // 32 * 16
    return stage_bytes >= ROW_MIN_STAGE and half >= 2 * _pad8(A) and half >= 2 * _pad8(C)


def _row_chunks(n, first, ld0, ld1, stage_bytes):
    """attn_row::chunks: the stage's plan for n listed positions read in two
    passes, rows of ld0 then ld1 bf16 (`first` False: no pass 0): whole
    (both passes' rows staged together) or streamed through the stage's two
    halves; positions a chunk of each pass (p0, p1), and the chunks of each
    (n0, n1), pass 0's first. An empty list has no chunk."""
    if n < 1:
        return dict(whole=False, p0=0, p1=0, n0=0, n1=0)
    e0 = n * ld0 * 2 if first else 0
    if e0 + n * ld1 * 2 <= stage_bytes:
        whole, p0, p1 = True, n, n
    else:
        half = stage_bytes // 32 * 16
        whole, p0, p1 = False, half // (ld0 * 2), half // (ld1 * 2)
    return dict(whole=whole, p0=p0, p1=p1, n0=-(-n // p0) if first else 0, n1=-(-n // p1))


def attn_row_chunks(n, scores, A, C, stage_bytes):
    """The forward row routine's stage plan for n listed positions
    (`scores` False: a fully masked row, whose ep is not read): ep's rows
    for the scores, then enc's for ctx; positions a chunk of ep (pa) and of
    enc (pc), and the chunks of each (na, nc)."""
    k = _row_chunks(n, scores, _pad8(A), _pad8(C), stage_bytes)
    return dict(whole=k["whole"], pa=k["p0"], pc=k["p1"], na=k["n0"], nc=k["n1"])


def attn_bwd_chunks(n, A, C, stage_bytes):
    """The backward row routine's stage plan for a rank's n listed
    positions: enc's rows for dα, then ep's for ddp; positions a chunk of
    enc (pc) and of ep (pa), and the chunks of each (nc, na)."""
    k = _row_chunks(n, True, _pad8(C), _pad8(A), stage_bytes)
    return dict(whole=k["whole"], pc=k["p0"], pa=k["p1"], nc=k["n0"], na=k["n1"])


@functools.lru_cache(maxsize=None)
def attn_bwd_cluster(S):
    """The ranks of attn_bwd_step's cluster a row: one for every
    ATTN_RANK_POSITIONS (32) source positions, at most ATTN_MAX_CLUSTER (4):
    2 at the main path's S = 50, so a full row's 50 positions are split 25
    and 25 over two CTAs (and 256 rows take 512 CTAs, one wave at four an
    SM on a 132-SM card)."""
    return min(ATTN_MAX_CLUSTER, -(-S // ATTN_RANK_POSITIONS))


def attn_bwd_ranges(n, ranks):
    """Each rank's contiguous range [j0, j1) of a row's n listed positions,
    as attend_bwd cuts it: ceil(n / ranks) a rank, the last ranks' shorter
    or empty."""
    per = -(-n // ranks)
    return [(min(n, q * per), min(n, (q + 1) * per)) for q in range(ranks)]


def row_path(A, C):
    """How the row routine stages a row: rows of a multiple of 16 bytes in
    bf16 (A and C multiples of 8) by the bulk-copy engine, other rows by
    plain loads, zero-padded to a multiple of 8 elements."""
    return ATTN_BULK if A % 8 == 0 and C % 8 == 0 else ATTN_LOADS


@functools.lru_cache(maxsize=None)
def attn_fwd_path(S, A, C, dtype):
    """attn_fwd's kernel for a shape, decided before any launch: in bf16
    csrc/bahdanau_attn.cu's attn_fwd_row_kernel on `row_path`'s staging;
    in f32, and in bf16 past the row routine's C (8192), its 96 KB stage (A
    or C past 24576) or a block's shared memory (S and A together past
    about 16700), the first design `attn_fwd_kernel`."""
    if (dtype != torch.bfloat16 or C > ROW_MAX_C or not row_stage_fits(A, C, ATTN_ROW_STAGE)
            or row_fixed_bytes(S, A) + ATTN_ROW_STAGE > CARD_SMEM):
        return FIRST
    return row_path(A, C)


@functools.lru_cache(maxsize=None)
def attn_bwd_path(S, A, C, dtype):
    """attn_bwd_step's kernel for a shape, decided before any launch: in
    bf16 csrc/bahdanau_attn.cu's attn_bwd_row_kernel on `row_path`'s
    staging; in f32, and in bf16 past the row routine's A (8192, its ddp
    columns), its 45 KB stage (A or C past 11520) or a block's shared memory
    (S, A and C together), the first design `attn_bwd_step_kernel`."""
    if (dtype != torch.bfloat16 or A > ROW_MAX_C or not row_stage_fits(A, C, ATTN_BWD_STAGE)
            or row_bwd_fixed_bytes(S, A, C, attn_bwd_cluster(S)) + ATTN_BWD_STAGE > CARD_SMEM):
        return FIRST
    return row_path(A, C)


def dep_blocks(S):
    """The walk's blocks of DEP_POSITIONS listed positions a row (its
    dv_part rows a batch row)."""
    return -(-S // DEP_POSITIONS)


def seq_layout(B, A, C, H):
    """The bf16 whole-sequence kernels' widths: H, A and C padded to whole
    16s (Hp, Ap, Cp), the unit groups n_ug = Hp / 16, each CTA's slice of C
    in the backward (cs: C over the unit groups, rounded up to a whole
    n-tile of 8) and of A in the forward (as, the same of A), and the 32-row
    sub-tiles of B."""
    Hp, Ap, Cp = (-(-n // 16) * 16 for n in (H, A, C))
    n_ug = Hp // SEQ_UNITS
    slice_of = lambda n: -(-(-(-n // n_ug)) // 8) * 8  # noqa: E731
    return {"Hp": Hp, "Ap": Ap, "Cp": Cp, "n_ug": n_ug, "cs": slice_of(C), "as": slice_of(A),
            "n_tiles": -(-B // SEQ_ROWS)}


def seq_fwd_smem(tiles, S, A, C, H, w_smem, stage):
    """tcb::fwd_smem: the row routine's fixed part, the sub-tiles' state,
    the weights' slices where they are in shared memory, the stage."""
    lay = seq_layout(1, A, C, H)
    w = ((48 + lay["as"]) * (lay["Hp"] + 8) + 48 * (lay["Cp"] + 8)) * 2 if w_smem else 0
    return row_fixed_bytes(S, A) + tiles * SEQ_FSTATE_BYTES + w + stage


def seq_fwd_route(B, S, A, C, H, dtype):
    """decoder_seq_fwd's kernel for a shape, decided before any launch:
    SEQ_TC (the bf16 forward on tensor cores) where its plan places the
    shape on the card the rule is stated for (CARD_SMS, CARD_SMEM): a slice
    of A of at most 64 columns (A at most 4·H, about), C within the row
    routine's 8192, rows of A and C the ring stages (6912 at most), at most
    one unit group an SM (H up to 2112), and one sub-tile's state beside the
    ring within a block's shared memory with the weights read through L1.
    FIRST (the first design) for f32 and every other shape."""
    lay = seq_layout(B, A, C, H)
    if (dtype != torch.bfloat16 or lay["as"] > SEQ_MAX_AS or C > ROW_MAX_C
            or not row_stage_fits(A, C, SEQ_RING_BYTES) or lay["n_ug"] > CARD_SMS
            or seq_fwd_smem(1, S, A, C, H, False, SEQ_RING_BYTES) > CARD_SMEM):
        return FIRST
    return SEQ_TC


def seq_fwd_weights(wa_dec, wx_c, w_ur, w_c):
    """The bf16 forward's weights, each row the K-contiguous B column of one
    output, zero where a unit, a column or k is padding: wg [n_ug·48, Hp]
    (row 48x + 16q + i: gate q's column of unit 16x + i, q over u and r of
    w_ur and c of w_c), wx [n_ug·48, Cp] (the same of wx_c's gates), wa
    [n_ug·as, Hp] (row a: wa_dec's column a)."""
    H, A, C = w_c.shape[0], wa_dec.shape[1], wx_c.shape[0]
    lay = seq_layout(1, A, C, H)
    Hp, Cp, n_ug = lay["Hp"], lay["Cp"], lay["n_ug"]
    new = lambda *shape: torch.zeros(*shape, dtype=w_c.dtype, device=w_c.device)  # noqa: E731
    wg, wx, wa = new(3, Hp, Hp), new(3, Hp, Cp), new(n_ug * lay["as"], Hp)
    wg[:2, :H, :H] = w_ur.reshape(H, 2, H).permute(1, 2, 0)
    wg[2, :H, :H] = w_c.T
    wx[:, :H, :C] = wx_c.reshape(C, 3, H).permute(1, 2, 0)
    wa[:A, :H] = wa_dec.T
    by_unit = lambda w: w.reshape(3, n_ug, SEQ_UNITS, -1).transpose(0, 1).reshape(  # noqa: E731
        n_ug * 3 * SEQ_UNITS, -1).contiguous()
    return by_unit(wg), by_unit(wx), wa


def _aligned(t):
    """t, or a copy where its data is not 16-byte aligned (the bulk-copy
    engine's rows need it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# --------------------------------------------------------------- wrappers --
_LIB = None


def _lib():
    """csrc/bahdanau_attn.cu's library, built and bound once a process."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("bahdanau_attn")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_fwd_launch.argtypes = [i] + [ptr] * 7 + [i] * 4 + [ptr]
        lib.attn_bwd_step_launch.argtypes = [i] + [ptr] * 9 + [i] * 4 + [ptr]
        lib.attn_phase2_launch.argtypes = [i] + [ptr] * 8 + [i] * 4 + [ptr]
        lib.attn_fwd_row_launch.argtypes = [ptr] * 7 + [i] * 5 + [ptr]
        lib.attn_bwd_row_launch.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
        lib.attn_bwd_row_timed_launch.argtypes = [ptr] * 9 + [i] * 6 + [ptr, ptr]
        lib.attn_dep_launch.argtypes = [i, i] + [ptr] * 7 + [i] * 4 + [ptr]
        for fn in (lib.attn_fwd_launch, lib.attn_bwd_step_launch, lib.attn_phase2_launch,
                   lib.attn_fwd_row_launch, lib.attn_bwd_row_launch,
                   lib.attn_bwd_row_timed_launch, lib.attn_dep_launch):
            fn.restype = i
        lib.attn_error_string.argtypes = [i]
        lib.attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


_CURRENT = contextlib.nullcontext()


def _f32(mask):
    """The mask as the kernels read it, f32 and contiguous: itself where it
    already is (no conversion call a step)."""
    return mask if mask.dtype == torch.float32 and mask.is_contiguous() else \
        mask.to(torch.float32).contiguous()


def _on(device):
    """The context that makes `device` current for a launch: none where it
    already is, which saves a per-step wrapper two device switches a call."""
    return _CURRENT if device.index == torch.cuda.current_device() else torch.cuda.device(device)


def _check(name, ep, others):
    """ep [B,S,A] sets the shapes; `others` maps a name to (tensor, shape,
    dtype), dtype None meaning ep's io dtype and "any" no check."""
    if ep.dim() != 3 or min(ep.shape) < 1:
        raise ValueError(f"{name}: ep must be a non-empty [B,S,A], got {tuple(ep.shape)}")
    if ep.dtype not in _IO_DTYPES:
        raise TypeError(f"{name}: io dtype must be float32 or bfloat16, got {ep.dtype}")
    dev = ep.device  # the per-step wrappers' host floor: no tuple or device made twice
    for arg, (t, shape, dtype) in others.items():
        if t.shape != shape:  # a torch.Size against the tuple
            raise ValueError(f"{name}: {arg} must be {list(shape)}, got {list(t.shape)}")
        want = dtype or ep.dtype
        if want != "any" and t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {want}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, ep on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _raise(lib, name, err, shapes):
    raise RuntimeError(f"{name} kernel launch failed ({shapes}): "
                       f"{lib.attn_error_string(err).decode()}")


def attn_fwd(ep, enc, dp, v, mask):
    """One decoder step's attention; see attn_fwd_plain for the contract.
    CUDA tensors launch the sm_90a kernel `attn_fwd_path` names; CPU
    tensors run the plain version."""
    global attn_fwd_launches
    B, S, A = ep.shape
    C = enc.shape[-1] if enc.dim() == 3 else -1
    _check("attn_fwd", ep, {"enc": (enc, (B, S, C), None), "dp": (dp, (B, A), None),
                            "v": (v, (A,), None), "mask": (mask, (B, S), "any")})
    if ep.device.type == "cpu":
        return attn_fwd_plain(ep, enc, dp, v, mask)
    path = attn_fwd_path(S, A, C, ep.dtype)
    ep, enc, dp, v = (t.contiguous() for t in (ep, enc, dp, v))
    if path == ATTN_BULK:
        ep, enc = _aligned(ep), _aligned(enc)
    mask = _f32(mask)
    lib = _lib()
    with _on(ep.device):
        ctx = torch.empty(B, C, dtype=ep.dtype, device=ep.device)
        alpha = torch.empty(B, S, dtype=torch.float32, device=ep.device)
        ptrs = (ep.data_ptr(), enc.data_ptr(), dp.data_ptr(), v.data_ptr(), mask.data_ptr(),
                ctx.data_ptr(), alpha.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if path == FIRST:
            err = lib.attn_fwd_launch(int(ep.dtype == torch.bfloat16), *ptrs, B, S, A, C, stream)
        else:
            err = lib.attn_fwd_row_launch(*ptrs, B, S, A, C, int(path == ATTN_BULK), stream)
    if err != 0:
        _raise(lib, "attn_fwd", err, f"{path} path, B={B} S={S} A={A} C={C} {ep.dtype}")
    attn_fwd_launches += 1
    attn_fwd_paths[path] += 1
    return ctx, alpha


def attn_bwd_step(ep, enc, dp, v, mask, dctx, alpha):
    """One step's attention backward; see attn_bwd_step_plain. CUDA tensors
    launch the sm_90a kernel `attn_bwd_path` names; in bf16 a row whose
    dctx is all zero, or with no valid position, gets ddp = dsc = 0 without
    reading ep or enc (the plain answer for finite inputs: a NaN in such a
    row of ep or enc is not propagated). CPU tensors run the plain
    version."""
    global attn_bwd_step_launches
    B, S, A = ep.shape
    C = enc.shape[-1] if enc.dim() == 3 else -1
    _check("attn_bwd_step", ep, {
        "enc": (enc, (B, S, C), None), "dp": (dp, (B, A), None), "v": (v, (A,), None),
        "mask": (mask, (B, S), "any"), "dctx": (dctx, (B, C), None),
        "alpha": (alpha, (B, S), torch.float32)})
    if ep.device.type == "cpu":
        return attn_bwd_step_plain(ep, enc, dp, v, mask, dctx, alpha)
    path = attn_bwd_path(S, A, C, ep.dtype)
    ep, enc, dp, v, dctx, alpha = (t.contiguous() for t in (ep, enc, dp, v, dctx, alpha))
    if path == ATTN_BULK:
        ep, enc = _aligned(ep), _aligned(enc)
    mask = _f32(mask)
    lib = _lib()
    with _on(ep.device):
        ddp = torch.empty(B, A, dtype=ep.dtype, device=ep.device)
        dsc = torch.empty(B, S, dtype=torch.float32, device=ep.device)
        ptrs = (ep.data_ptr(), enc.data_ptr(), dp.data_ptr(), v.data_ptr(), mask.data_ptr(),
                dctx.data_ptr(), alpha.data_ptr(), ddp.data_ptr(), dsc.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if path == FIRST:
            err = lib.attn_bwd_step_launch(int(ep.dtype == torch.bfloat16), *ptrs, B, S, A, C,
                                           stream)
        else:
            err = lib.attn_bwd_row_launch(*ptrs, B, S, A, C, attn_bwd_cluster(S),
                                          int(path == ATTN_BULK), stream)
    if err != 0:
        _raise(lib, "attn_bwd_step", err, f"{path} path, B={B} S={S} A={A} C={C} {ep.dtype}")
    attn_bwd_step_launches += 1
    attn_bwd_step_paths[path] += 1
    return ddp, dsc


def attn_bwd_step_phase_us(ep, enc, dp, v, mask, dctx, alpha):
    """The bf16 attn_bwd_step kernel's phases on the card, from one launch
    of its timed instance, whose CTAs' thread 0 record the device's ns clock
    at its start and at attend_bwd's points. Returns, over the live CTAs (a row with a nonzero
    dctx and a valid position), the mean µs of each phase: "loads, the
    list"; "enc staged, dα"; "Σα·dα exchange"; "ep staged, ddp"; "partials
    to rank 0"; and the latest live CTA's end and the dead CTAs' mean
    lifetime, from the first CTA's start; the live and dead CTAs. Counted
    as no launch; the executor never calls it."""
    B, S, A = ep.shape
    C = enc.shape[2]
    path = attn_bwd_path(S, A, C, ep.dtype)
    if path == FIRST or A > ROW_MAX_C // 4:  # one group of 8 columns a thread
        raise ValueError(f"attn_bwd_step_phase_us: S={S} A={A} C={C} {ep.dtype} is not on the "
                         "row routine's one-group kernel")
    ranks = attn_bwd_cluster(S)
    ep, enc, dp, v, dctx, alpha = (t.contiguous() for t in (ep, enc, dp, v, dctx, alpha))
    mask = _f32(mask)
    lib = _lib()
    with _on(ep.device):
        ddp = torch.empty(B, A, dtype=ep.dtype, device=ep.device)
        dsc = torch.empty(B, S, dtype=torch.float32, device=ep.device)
        clk = torch.zeros(B * ranks, 8, dtype=torch.int64, device=ep.device)
        err = lib.attn_bwd_row_timed_launch(
            ep.data_ptr(), enc.data_ptr(), dp.data_ptr(), v.data_ptr(), mask.data_ptr(),
            dctx.data_ptr(), alpha.data_ptr(), ddp.data_ptr(), dsc.data_ptr(), B, S, A, C, ranks,
            int(path == ATTN_BULK), clk.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, "attn_bwd_step (timed)", err, f"B={B} S={S} A={A} C={C}")
    c = clk.cpu().double()
    t0 = float(c[:, 0].min())
    live = c[:, 5] > 0
    names = ("loads, the list", "enc staged, dα", "Σα·dα exchange", "ep staged, ddp",
             "partials to rank 0")
    out = {"us": {n: float((c[live, i + 1] - c[live, i]).mean()) / 1e3 if live.any() else 0.0
                  for i, n in enumerate(names)},
           "live_end_us": float(c[live, 5].max() - t0) / 1e3 if live.any() else 0.0,
           "dead_us": float((c[~live, 6] - c[~live, 0]).mean()) / 1e3 if (~live).any() else 0.0,
           "live_ctas": int(live.sum()), "dead_ctas": int((~live).sum())}
    return out


def _dep(name, ep, dp_seq, dsc_seq, v, newest):
    """The walk over the nonzero terms (attn_dep_kernel, then attn_dv_kernel)
    on the card: returns (dep, dv). Raises past DEP_MAX_S source positions
    (the row's order of them in shared memory)."""
    T, B, A = dp_seq.shape
    S = ep.shape[1]
    if S > DEP_MAX_S:
        raise ValueError(f"{name}: S={S} is past the walk's {DEP_MAX_S} source positions")
    ep, dp_seq, dsc_seq, v = (t.contiguous() for t in (ep, dp_seq, dsc_seq, v))
    lib = _lib()
    with _on(ep.device):
        dep = torch.empty(B, S, A, dtype=ep.dtype, device=ep.device)
        dv = torch.empty(A, dtype=torch.float32, device=ep.device)
        dv_part = torch.empty(B * dep_blocks(S), A, dtype=torch.float32, device=ep.device)
        err = lib.attn_dep_launch(
            int(ep.dtype == torch.bfloat16), int(newest), ep.data_ptr(), dp_seq.data_ptr(),
            dsc_seq.data_ptr(), v.data_ptr(), dep.data_ptr(), dv.data_ptr(), dv_part.data_ptr(),
            T, B, S, A, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, name, err, f"walk, T={T} B={B} S={S} A={A} {ep.dtype}")
    return dep, dv


def attn_phase2(ep, dp_seq, dsc_seq, v):
    """d(enc_proj) and dv over all steps; see attn_phase2_plain. CUDA
    tensors launch csrc/bahdanau_attn.cu's walk (attn_dep_kernel at the io
    dtype's instance, S up to DEP_MAX_S): it sums each dep element over t
    oldest first with the plain version's ops, skipping the terms with dsc
    = 0 (which add nothing), and dv from partials in a fixed order, without
    float atomics, so two runs give the same bits."""
    global attn_phase2_launches
    B, S, A = ep.shape
    T = dp_seq.shape[0] if dp_seq.dim() == 3 else -1
    _check("attn_phase2", ep, {"dp_seq": (dp_seq, (T, B, A), None),
                               "dsc_seq": (dsc_seq, (T, B, S), torch.float32),
                               "v": (v, (A,), None)})
    if T < 1:
        raise ValueError(f"attn_phase2: empty dp_seq {tuple(dp_seq.shape)}")
    if ep.device.type == "cpu":
        return attn_phase2_plain(ep, dp_seq, dsc_seq, v)
    out = _dep("attn_phase2", ep, dp_seq, dsc_seq, v, newest=False)
    attn_phase2_launches += 1
    return out


def _seq_lib():
    lib = cuda_build.load("decoder_seq")
    if lib.decoder_seq_fwd_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.decoder_seq_fwd_launch, lib.decoder_seq_bwd_launch):
            fn.argtypes = [i, ctypes.POINTER(ptr)] + [i] * 6 + [ptr]
            fn.restype = i
        lib.decoder_seq_bwd_tc_launch.argtypes = [ctypes.POINTER(ptr)] + [i] * 6 + [ptr]
        lib.decoder_seq_bwd_tc_plan.argtypes = [i] * 5 + [ptr]
        lib.decoder_seq_fwd_tc_launch.argtypes = [ctypes.POINTER(ptr)] + [i] * 7 + [ptr]
        lib.decoder_seq_fwd_tc_plan.argtypes = [i] * 5 + [ptr]
        for fn in (lib.decoder_seq_bwd_tc_launch,
                   lib.decoder_seq_bwd_tc_plan, lib.decoder_seq_fwd_tc_launch,
                   lib.decoder_seq_fwd_tc_plan):
            fn.restype = i
        lib.decoder_seq_ctas.argtypes = [i]
        lib.decoder_seq_ctas.restype = i
        lib.decoder_seq_error_string.argtypes = [i]
        lib.decoder_seq_error_string.restype = ctypes.c_char_p
    return lib


def _seq_dims(name, ep, enc, xs):
    """(B, S, A) of ep [B,S,A], C of enc [B,S,C] and (T, H) of xs, a
    [T,B,.H] tensor, as far as their ranks allow (-1 where not): _check
    then holds every tensor to them."""
    B, S, A = ep.shape if ep.dim() == 3 else (-1, -1, -1)
    C = enc.shape[2] if enc.dim() == 3 else -1
    T, H = xs.shape[0], xs.shape[2]
    if T < 1 or H < 1:
        raise ValueError(f"{name}: empty sequence or hidden width {tuple(xs.shape)}")
    return B, S, A, C, T, H


def _seq_launch(name, fn, ins, outs, dims, dt, lead=(), tail=()):
    """One launch of a whole-sequence kernel: `lead` (the first design's io
    dtype flag), every pointer in order, then T, B, S, A, C, H as far as
    `dims` goes, then `tail` (the bf16 forward's timed flag); raises with
    the kernel's error."""
    lib = _seq_lib()
    ptrs = (ctypes.c_void_p * (len(ins) + len(outs)))(*(t.data_ptr() for t in (*ins, *outs)))
    err = getattr(lib, fn)(*lead, ptrs, *dims, *tail, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        shape = " ".join(f"{k}={v}" for k, v in zip("TBSACH", dims))
        raise RuntimeError(
            f"{name} kernel launch failed ({shape} {dt}; the first design takes H up to 16 "
            "units a CTA and its weights' slices within one SM's shared memory, the bf16 "
            f"backward a slice of C up to {SEQ_MAX_SLICE} columns a CTA and a shape "
            "decoder_seq_bwd_plan places, the bf16 forward a shape seq_fwd_route sends it): "
            f"{lib.decoder_seq_error_string(err).decode()}")


def seq_bwd_weights(w_c, w_ur, wx_c, wa_dec):
    """The bf16 backward's weights, each row the K-contiguous B column of one
    output, padded as its exchange is: wu [Hp, 3Hp] (row j: unit j's w_u |
    w_r | w_c, from pad_w_bwd), wad [Hp, Ap] (row j: unit j's wa_dec), wxc
    [n_ug·cs, 3Hp] (row c: wx_c's row c, its gates at q·Hp); zero where a
    unit, k or column is padding."""
    H, A, C = w_c.shape[0], wa_dec.shape[1], wx_c.shape[0]
    lay = seq_layout(1, A, C, H)
    Hp, Ap = lay["Hp"], lay["Ap"]
    wu = pad_w_bwd(torch.cat([w_ur, w_c], -1))
    wad = torch.zeros(Hp, Ap, dtype=wa_dec.dtype, device=wa_dec.device)
    wad[:H, :A] = wa_dec
    wxc = torch.zeros(lay["n_ug"] * lay["cs"], 3, Hp, dtype=wx_c.dtype, device=wx_c.device)
    wxc[:C, :, :H] = wx_c.reshape(C, 3, H)
    return wu, wad, wxc.reshape(-1, 3 * Hp)


def decoder_seq_bwd_plan(B, S, A, C, H):
    """How the current card takes the bf16 backward at these widths: CTAs
    an SM, batch groups, 32-row sub-tiles a group, columns of C a CTA, and
    whether the weights' slices are in shared memory; raises for a shape
    it cannot place."""
    lib = _seq_lib()
    out = (ctypes.c_int * 5)()
    err = lib.decoder_seq_bwd_tc_plan(B, S, A, C, H, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"decoder_seq_bwd: no plan for B={B} S={S} A={A} C={C} H={H}: "
                           f"{lib.decoder_seq_error_string(err).decode()}")
    return dict(per_sm=out[0], groups=out[1], tiles_per_group=out[2], cs=out[3],
                w_smem=bool(out[4]))


def decoder_seq_fwd_plan(B, S, A, C, H):
    """How the current card takes the bf16 forward at these widths: CTAs an
    SM, batch groups, 32-row sub-tiles a group, columns of A a CTA, whether
    the weights' slices are in shared memory, the attention's stage and the
    shared memory a CTA (bytes); raises for a shape it cannot place."""
    lib = _seq_lib()
    out = (ctypes.c_int * 7)()
    err = lib.decoder_seq_fwd_tc_plan(B, S, A, C, H, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"decoder_seq_fwd: no plan for B={B} S={S} A={A} C={C} H={H}: "
                           f"{lib.decoder_seq_error_string(err).decode()}")
    return {"per_sm": out[0], "groups": out[1], "tiles_per_group": out[2], "as": out[3],
            "w_smem": bool(out[4]), "stage": out[5], "smem": out[6]}


def _decoder_seq_fwd_tc(args, dims, timed=False):
    """The bf16 forward on the card (csrc/decoder_seq.cu
    decoder_seq_fwd_tc_kernel). Returns (h_seq, alpha, ctx) and, where
    `timed`, the timed instance's clocks [CTAs, 4T + 3] (int64)."""
    T, B, S, A, C, H = dims
    ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c = args
    lay = seq_layout(B, A, C, H)
    Hp, Cp, n_dp = lay["Hp"], lay["Cp"], lay["n_ug"] * lay["as"]
    ins = [t.contiguous() for t in (ep, enc, mask, xpx, tmask, h0, v)]
    ins[:2] = [_aligned(t) for t in ins[:2]]
    ins += list(seq_fwd_weights(wa_dec, wx_c, w_ur, w_c))
    with torch.cuda.device(ep.device):
        new = lambda *shape, dtype=torch.bfloat16: torch.empty(*shape, dtype=dtype,  # noqa
                                                               device=ep.device)
        outs = [new(T, B, H), new(T, B, S, dtype=torch.float32), new(T, B, C)]
        # zeroed: the h exchange [2,B,Hp] (h0 in slot 0), the r·h [B,Hp] and
        # ctx [B,Cp] exchanges (their padding stays zero), the dp exchange
        # [B, n_ug·as] f32 and the batch groups' counters
        nh, nr, nc = 2 * B * Hp * 2, B * Hp * 2, B * Cp * 2
        ws = torch.zeros(nh + nr + nc + 4 * B * n_dp + 4 * lay["n_tiles"], dtype=torch.uint8,
                         device=ep.device)
        hx = ws[:nh].view(torch.bfloat16).view(2, B, Hp)
        hx[0, :, :H] = ins[5]
        rx = ws[nh: nh + nr].view(torch.bfloat16)
        cx = ws[nh + nr: nh + nr + nc].view(torch.bfloat16)
        dpx = ws[nh + nr + nc: nh + nr + nc + 4 * B * n_dp].view(torch.float32)
        bar = ws[nh + nr + nc + 4 * B * n_dp:]
        if timed:
            plan = decoder_seq_fwd_plan(B, S, A, C, H)
            clk = torch.zeros(lay["n_ug"] * plan["groups"], 4 * T + 3, dtype=torch.int64,
                              device=ep.device)
        else:
            clk = bar  # not read
        _seq_launch("decoder_seq_fwd", "decoder_seq_fwd_tc_launch", ins,
                    outs + [hx, rx, cx, dpx, bar, clk], dims, ep.dtype, tail=(int(timed),))
    return (tuple(outs), clk) if timed else tuple(outs)


def decoder_seq_fwd_phase_us(ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c):
    """The bf16 forward's four phases on the card, by its timed instance:
    the same kernel, each CTA's thread 0 recording its SM's clock as it
    leaves each barrier, and the device's nanosecond clock at the start and
    the end to convert. Returns µs a time step of each phase (from the
    barrier before it to its own, the wait included), averaged over the
    CTAs: "dp, h·w_ur", "attention", "ctx·wx_c, u, r", "candidate, cell";
    and the SM clock in GHz. Counted as no launch; the executor never calls
    it."""
    T, H = xpx.shape[0], h0.shape[1]
    B, S, A = ep.shape
    C = enc.shape[2]
    if seq_fwd_route(B, S, A, C, H, ep.dtype) != SEQ_TC:
        raise ValueError(f"decoder_seq_fwd_phase_us: B={B} S={S} A={A} C={C} H={H} "
                         f"{ep.dtype} is not on the tensor-core route")
    _, clk = _decoder_seq_fwd_tc((ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c),
                                 (T, B, S, A, C, H), timed=True)
    c = clk.cpu().double()
    ghz = (c[:, 4 * T + 1] - c[:, 1]) / (c[:, 4 * T + 2] - c[:, 0])  # cycles a ns
    steps = (c[:, 2:4 * T + 2] - c[:, 1:4 * T + 1]).reshape(-1, T, 4).sum(1)
    us = (steps / ghz[:, None] / 1e3 / T).mean(0).tolist()
    names = ("dp, h·w_ur", "attention", "ctx·wx_c, u, r", "candidate, cell")
    return {"us": dict(zip(names, us)), "ghz": float(ghz.mean())}


def decoder_seq_fwd(ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c):
    """The whole-sequence decoder forward; see decoder_seq_fwd_plain for the
    contract. CUDA tensors launch the sm_90a kernel `seq_fwd_route` names
    (csrc/decoder_seq.cu); CPU tensors run the plain version."""
    global decoder_seq_fwd_launches
    if xpx.dim() != 3 or xpx.shape[2] % 3:
        raise ValueError(f"decoder_seq_fwd: xpx must be [T,B,3H], got {tuple(xpx.shape)}")
    B, S, A, C, T, H = _seq_dims("decoder_seq_fwd", ep, enc, xpx[..., : xpx.shape[2] // 3])
    _check("decoder_seq_fwd", ep, {
        "enc": (enc, (B, S, C), None), "mask": (mask, (B, S), torch.float32),
        "xpx": (xpx, (T, B, 3 * H), None), "tmask": (tmask, (T, B), torch.float32),
        "h0": (h0, (B, H), None), "wa_dec": (wa_dec, (H, A), None), "v": (v, (A,), None),
        "wx_c": (wx_c, (C, 3 * H), None), "w_ur": (w_ur, (H, 2 * H), None),
        "w_c": (w_c, (H, H), None)})
    args = (ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c)
    if ep.device.type == "cpu":
        return decoder_seq_fwd_plain(*args)
    dt = ep.dtype
    route = seq_fwd_route(B, S, A, C, H, dt)
    if route == SEQ_TC:
        outs = _decoder_seq_fwd_tc(args, (T, B, S, A, C, H))
    else:
        ins = [t.contiguous() for t in args]
        with torch.cuda.device(ep.device):
            new = lambda *shape, dtype=dt: torch.empty(*shape, dtype=dtype,  # noqa
                                                       device=ep.device)
            outs = [new(T, B, H), new(T, B, S, dtype=torch.float32), new(T, B, C),
                    new(B, A, dtype=torch.float32), new(B, H)]
            _seq_launch("decoder_seq_fwd", "decoder_seq_fwd_launch", ins, outs,
                        (T, B, S, A, C, H), dt, lead=(int(dt == torch.bfloat16),))
        outs = tuple(outs[:3])
    decoder_seq_fwd_launches += 1
    decoder_seq_fwd_routes[route] += 1
    return outs


def decoder_seq_bwd(ep, enc, mask, g_seq, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq, alpha_seq,
                    v, w_c, w_ur, wx_c, wa_dec):
    """The whole-sequence decoder backward; see decoder_seq_bwd_plain. dep
    and dv are summed in a fixed order without float atomics, so two runs
    give the same bits."""
    global decoder_seq_bwd_launches
    if hp_seq.dim() != 3:
        raise ValueError(f"decoder_seq_bwd: hp_seq must be [T,B,H], got {tuple(hp_seq.shape)}")
    B, S, A, C, T, H = _seq_dims("decoder_seq_bwd", ep, enc, hp_seq)
    seq = ((T, B, H), None)
    _check("decoder_seq_bwd", ep, {
        "enc": (enc, (B, S, C), None), "mask": (mask, (B, S), torch.float32),
        "g_seq": (g_seq, *seq), "tmask": (tmask, (T, B), torch.float32),
        "hp_seq": (hp_seq, *seq), "u_seq": (u_seq, *seq), "r_seq": (r_seq, *seq),
        "c_seq": (c_seq, *seq), "dp_seq": (dp_seq, (T, B, A), None),
        "alpha_seq": (alpha_seq, (T, B, S), torch.float32), "v": (v, (A,), None),
        "w_c": (w_c, (H, H), None), "w_ur": (w_ur, (H, 2 * H), None),
        "wx_c": (wx_c, (C, 3 * H), None), "wa_dec": (wa_dec, (H, A), None)})
    args = (ep, enc, mask, g_seq, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq, alpha_seq, v, w_c,
            w_ur, wx_c, wa_dec)
    if ep.device.type == "cpu":
        return decoder_seq_bwd_plain(*args)
    dt = ep.dtype
    if dt == torch.bfloat16:
        return _decoder_seq_bwd_tc(args, (T, B, S, A, C, H))
    ins = [t.contiguous() for t in args]
    with torch.cuda.device(ep.device):
        ctas = _seq_lib().decoder_seq_ctas(H)
        if ctas < 1:
            raise RuntimeError(f"decoder_seq_bwd: H={H} is past the kernel's 16 units a CTA")
        new = lambda *shape, dtype=dt: torch.empty(*shape, dtype=dtype, device=ep.device)  # noqa
        outs = [new(T, B, 3 * H), new(T, B, C), new(T, B, A), new(B, H), new(B, S, A),
                new(A, dtype=torch.float32), new(B, S, A, dtype=torch.float32),
                new(ctas, A, dtype=torch.float32)]
        _seq_launch("decoder_seq_bwd", "decoder_seq_bwd_launch", ins, outs, (T, B, S, A, C, H), dt,
                    lead=(0,))
    decoder_seq_bwd_launches += 1
    return tuple(outs[:6])


def _decoder_seq_bwd_tc(args, dims):
    """decoder_seq_bwd in bf16 on the card: the walk on the tensor cores,
    then the post-walk d(enc_proj)/dv pass on its dsc."""
    global decoder_seq_bwd_launches
    T, B, S, A, C, H = dims
    ep = args[0]
    lay = seq_layout(B, A, C, H)
    Hp, Ap = lay["Hp"], lay["Ap"]
    w_c, w_ur, wx_c, wa_dec = args[12:]
    ins = [t.contiguous() for t in args[:12]] + list(seq_bwd_weights(w_c, w_ur, wx_c, wa_dec))
    with torch.cuda.device(ep.device):
        new = lambda *shape, dtype=torch.bfloat16: torch.empty(*shape, dtype=dtype,  # noqa
                                                               device=ep.device)
        outs = [new(T, B, 3 * H), new(T, B, C), new(T, B, A), new(B, H),
                new(T, B, S, dtype=torch.float32)]
        # zeroed: the [du | dr | dc] and ddp exchanges (their padding stays
        # zero) and the batch groups' barrier counters
        n_ex, n_dex = 2 * B * 3 * Hp, 2 * B * Ap
        ws = torch.zeros(2 * (n_ex + n_dex) + 4 * lay["n_tiles"], dtype=torch.uint8,
                         device=ep.device)
        ex = ws[: 2 * n_ex].view(torch.bfloat16)
        dex = ws[2 * n_ex: 2 * (n_ex + n_dex)].view(torch.bfloat16)
        bar = ws[2 * (n_ex + n_dex):]
        _seq_launch("decoder_seq_bwd", "decoder_seq_bwd_tc_launch", ins, outs + [ex, dex, bar],
                    dims, ep.dtype)
    decoder_seq_bwd_launches += 1
    dxp, dctx, ddp, dh0, dsc = outs
    dep, dv = decoder_seq_dep(ins[0], ins[9], dsc, ins[11])
    return dxp, dctx, ddp, dh0, dep, dv


def decoder_seq_dep(ep, dp_seq, dsc_seq, v):
    """The backward's d(enc_proj) and dv from the walk's dsc; see
    decoder_seq_dep_plain. CUDA bf16 tensors launch B7's walk
    (csrc/bahdanau_attn.cu attn_dep_kernel) with t newest first: each
    element summed by one thread in the plain version's order, the terms
    with dsc = 0 skipped, dv's partials added in a fixed order, the same
    bits on every run; CPU tensors run the plain version."""
    global decoder_seq_dep_launches
    B, S, A = ep.shape if ep.dim() == 3 else (-1, -1, -1)
    T = dp_seq.shape[0] if dp_seq.dim() == 3 else -1
    _check("decoder_seq_dep", ep, {"dp_seq": (dp_seq, (T, B, A), None),
                                   "dsc_seq": (dsc_seq, (T, B, S), torch.float32),
                                   "v": (v, (A,), None)})
    if T < 1:
        raise ValueError(f"decoder_seq_dep: empty dp_seq {tuple(dp_seq.shape)}")
    if ep.device.type == "cpu":
        return decoder_seq_dep_plain(ep, dp_seq, dsc_seq, v)
    if ep.dtype != torch.bfloat16:
        raise TypeError(f"decoder_seq_dep: the card's pass takes bf16, got {ep.dtype}")
    out = _dep("decoder_seq_dep", ep, dp_seq, dsc_seq, v, newest=True)
    decoder_seq_dep_launches += 1
    return out


def decoder_bwd_inputs(trg, h0, wa_dec, wx, wh, bias, h_seq, ctx_seq):
    """The backward's batched recompute of every gate from the forward's
    h_seq and ctx_seq (no sequential dependency), as `_decoder_fn`'s bwd
    does it (bahdanau_kernels.py:736-747), each product rounded to the io
    dtype once, from [trg, ctx] concatenated: so in bf16 the backward sees
    slightly other gates than the whole-sequence forward used, as the TPU
    kernels' do. Returns (hp_seq, dp_seq, xin_seq, u_seq, r_seq, rh_seq,
    c_seq)."""
    H = h0.shape[-1]
    hp_seq = torch.cat([h0[None], h_seq[:-1]])
    dp_seq = torch.matmul(hp_seq, wa_dec)
    xin_seq = torch.cat([trg, ctx_seq], -1)
    xp_seq = torch.matmul(xin_seq, wx) + bias
    ur_seq = sigmoid(xp_seq[..., : 2 * H] + torch.matmul(hp_seq, wh[:, : 2 * H]))
    u_seq, r_seq = ur_seq[..., :H], ur_seq[..., H:]
    rh_seq = r_seq * hp_seq
    c_seq = torch.tanh(xp_seq[..., 2 * H:] + torch.matmul(rh_seq, wh[:, 2 * H:]))
    return hp_seq, dp_seq, xin_seq, u_seq, r_seq, rh_seq, c_seq


def _decoder_bwd_steps(ep, enc, maskf, g_seq, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq,
                       alpha_seq, v, w_c, w_ur, wx_ctx, wa_dec):
    """The scan's backward (decoder_seq_bwd's contract): the dh chain in the
    io dtype, newest step first, one attn_bwd_step a step, then attn_phase2
    for d(enc_proj) and dv."""
    dt = hp_seq.dtype
    T = hp_seq.shape[0]
    dh = torch.zeros_like(hp_seq[0])
    dxp_seq, dctx_seq = [None] * T, [None] * T
    dsc_seq, ddp_seq = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        hp, u, r, c = hp_seq[t], u_seq[t], r_seq[t], c_seq[t]
        dh = dh + g_seq[t]
        m = tmask[t][:, None].to(dt)
        dh_cell = dh * m
        dh_prev = dh * (1 - m)
        du = dh_cell * (c - hp)
        dc = dh_cell * u
        dh_prev = dh_prev + dh_cell * (1 - u)
        dpre_c = dc * (1 - c * c)
        drh = torch.matmul(dpre_c, w_c.T)
        dr = drh * hp
        dh_prev = dh_prev + drh * r
        dpre_u = du * u * (1 - u)
        dpre_r = dr * r * (1 - r)
        dur = torch.cat([dpre_u, dpre_r], -1)
        dh_prev = dh_prev + torch.matmul(dur, w_ur.T)
        dxp = torch.cat([dur, dpre_c], -1)
        dctx = torch.matmul(dxp, wx_ctx.T)
        ddp, dsc = attn_bwd_step(ep, enc, dp_seq[t], v, maskf, dctx, alpha_seq[t])
        dh = dh_prev + torch.matmul(ddp, wa_dec.T)
        dxp_seq[t], dctx_seq[t], dsc_seq[t], ddp_seq[t] = dxp, dctx, dsc, ddp
    dsc_seq = torch.stack(dsc_seq)
    # the [B,S,A]-sized gradient, written once
    dep, dv = attn_phase2(ep, dp_seq, dsc_seq, v)
    return torch.stack(dxp_seq), torch.stack(dctx_seq), torch.stack(ddp_seq), dh, dep, dv


# ----------------------------------------------------- the decoder Function --
class _DecoderFn(torch.autograd.Function):
    """Teacher-forcing attention-GRU decoder: the counterpart of
    `_decoder_fn` (bahdanau_kernels.py:665-823), its scan branches or, with
    FLAGS.fused_attention_seq_fwd / _bwd, its whole-sequence ones.

    (enc [B,S,C], ep [B,S,A], maskf [B,S], trg [T,B,E], tmask [T,B], h0,
     wa_dec [H,A], v [A], wx [(E+C),3H], wh [H,3H], bias [3H]) -> h_seq,
    everything but the two masks in one io dtype. The GRU cell computes in
    the io dtype, as `_gru_fwd_step` does."""

    @staticmethod
    def forward(ctx, enc, ep, maskf, trg, tmask, h0, wa_dec, v, wx, wh, bias):
        T, B, E = trg.shape
        H = h0.shape[-1]
        dt = h0.dtype
        if FLAGS.fused_attention_seq_fwd:
            # the x-half of the gate projection has no sequential dependency:
            # one batched product, outside the kernel
            xpx = torch.matmul(trg, wx[:E]) + bias
            h_seq, alpha_seq, ctx_seq = decoder_seq_fwd(
                ep, enc, maskf, xpx, tmask, h0, wa_dec, v, wx[E:], wh[:, : 2 * H], wh[:, 2 * H:])
        else:
            h = h0
            h_seq, alpha_seq, ctx_seq = [], [], []
            for t in range(T):
                dp = torch.matmul(h, wa_dec)
                ctx_t, alpha = attn_fwd(ep, enc, dp, v, maskf)
                xp = torch.matmul(torch.cat([trg[t], ctx_t], -1), wx) + bias
                hn = gru_cell(xp, h, wh, sigmoid, torch.tanh)
                m = tmask[t][:, None].to(dt)
                h = m * hn + (1 - m) * h
                h_seq.append(h)
                alpha_seq.append(alpha)
                ctx_seq.append(ctx_t)
            h_seq, alpha_seq, ctx_seq = (torch.stack(x) for x in (h_seq, alpha_seq, ctx_seq))
        ctx.save_for_backward(enc, ep, maskf, trg, tmask, h0, wa_dec, v, wx, wh, bias,
                              h_seq, alpha_seq, ctx_seq)
        return h_seq

    @staticmethod
    def backward(ctx, g_seq):
        (enc, ep, maskf, trg, tmask, h0, wa_dec, v, wx, wh, bias,
         h_seq, alpha_seq, ctx_seq) = ctx.saved_tensors
        T, B, H = h_seq.shape
        E = trg.shape[-1]
        dt = h_seq.dtype
        g_seq = g_seq.to(dt)
        hp_seq, dp_seq, xin_seq, u_seq, r_seq, rh_seq, c_seq = decoder_bwd_inputs(
            trg, h0, wa_dec, wx, wh, bias, h_seq, ctx_seq)
        w_ur, w_c = wh[:, : 2 * H], wh[:, 2 * H:]
        wx_ctx = wx[E:]
        if FLAGS.fused_attention_seq_bwd:
            dxp_seq, dctx_seq, ddp_seq, dh, dep, dv = decoder_seq_bwd(
                ep, enc, maskf, g_seq, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq, alpha_seq, v,
                w_c, w_ur, wx_ctx, wa_dec)
        else:
            dxp_seq, dctx_seq, ddp_seq, dh, dep, dv = _decoder_bwd_steps(
                ep, enc, maskf, g_seq, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq, alpha_seq, v,
                w_c, w_ur, wx_ctx, wa_dec)
        # the shared tail: batched products outside any kernel
        TB = T * B
        dx_seq = torch.matmul(dxp_seq, wx[:E].T)
        dxp2 = dxp_seq.reshape(TB, 3 * H)
        dwx = torch.matmul(xin_seq.reshape(TB, -1).T, dxp2)
        dbias = dxp_seq.sum((0, 1))
        hp2 = hp_seq.reshape(TB, H).T
        dwh = torch.cat([torch.matmul(hp2, dxp2[:, : 2 * H]),
                         torch.matmul(rh_seq.reshape(TB, H).T, dxp2[:, 2 * H:])], -1)
        dwa_dec = torch.matmul(hp2, ddp_seq.reshape(TB, -1))
        denc = torch.einsum("tbs,tbc->bsc", alpha_seq.to(dt), dctx_seq)
        return (denc, dep, None, dx_seq, None, dh, dwa_dec, dv.to(v.dtype), dwx, dwh, dbias)


def fused_attention_decoder(enc_b, enc_proj, enc_mask, trg_b, trg_mask, h0,
                            wa_dec, v_att, wx, wh, bias):
    """Public entry, the counterpart of bahdanau_kernels.fused_attention_decoder:
    enc_b [B,S,C], enc_proj [B,S,A], enc_mask [B,S] bool, trg_b [T,B,E],
    trg_mask [T,B], h0 [B,H], weights in trg_b's dtype, bias may be None.
    Returns h_seq [T,B,H]."""
    if bias is None:
        bias = torch.zeros(wx.shape[1], dtype=trg_b.dtype, device=trg_b.device)
    return _DecoderFn.apply(enc_b, enc_proj, enc_mask.to(torch.float32), trg_b,
                            trg_mask.to(torch.float32), h0, wa_dec, v_att, wx, wh, bias)
