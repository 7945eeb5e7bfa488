"""The bf16 flash kernels' block schedule (ops/flash_kernels.py
`bwd_schedule`, which csrc/flash_attn.cu's dkv_first, dq_last, dkv_masked
and dq_masked follow, and `q_schedule`, its dQ walk, which the forward
walks too), on the CPU.

The kernels need the card; what they walk does not. Each dK/dV CTA owns a
block of keys and walks query tiles, each dQ CTA owns a block of queries
and walks key tiles, and only the blocks the schedule marks evaluate the
causal test and the T bound. Two things are held here:

- Coverage: every visible (query, key) pair is visited exactly once by each
  kernel's CTAs, every row of the output is owned by one CTA, every block
  holding a pair that is not visible (past T, or a key after its query when
  causal) is marked, and causal CTAs with the most blocks launch first.
- Arithmetic: a plain tiled emulation of the two kernels in f32 that walks
  the schedule as the kernels do (tiles zero-filled past T as TMA reads
  them, LSE and Di rows 0 past T as the kernels stage them, exp2 with log2 e
  folded into the scale and the LSE, masks only where the schedule says)
  against flash_bwd_dkv_plain and flash_bwd_dq_plain, within 2e-6 of each
  output's largest element (measured at most 9.1e-7, dK: exp2 against exp
  and the blocks' f32 sums in another order). At T=1 each query sees one
  key, P = 1 and dS = 0, so dK and dQ are rounding noise on both sides,
  held instead to 2e-6 of their terms' magnitude, (|dP| + |Di|)·scale·|Q|
  (|K|). A diagonal block left unmasked
  reads keys after their queries and fails by orders of magnitude. Past T
  the zero-filled tiles already make each product's padded terms 0; the
  mask makes P itself 0 there.
- The forward: a tiled f32 emulation of flash_fwd_tc_kernel over
  q_schedule's walk (64-key tiles zero-filled past T, masks only on the
  flagged blocks, the online softmax in base 2 with scale·log2 e folded
  into the scores, LSE = m·ln 2 + log l) against flash_fwd_plain, O within
  2e-6 of its largest element and LSE within 2e-6 of its largest
  magnitude (measured at most 3.7e-7 and 1.3e-7). With the flagged masks
  left out, causal rows read later keys and past T the zero-filled keys
  take a share of the softmax: it fails by orders of magnitude.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_kernels as fk

T_CASES = [1, 63, 64, 65, 127, 128, 129, 200, 1000]
TILE_ROWS = [64, 128]  # rows a CTA owns: 64 (backward; a forward warpgroup), 128 (forward)
LOG2E = 1.4426950408889634
TOL = 2e-6


def _visible(T, causal):
    """[query, key] pairs that attention reads."""
    vis = np.ones((T, T), bool)
    return np.tril(vis) if causal else vis


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T", T_CASES)
def test_schedule_visits_each_visible_pair_once(T, causal, rows):
    sched = fk.bwd_schedule(T, causal, rows, fk.BWD_COLS)
    cols = fk.BWD_COLS
    vis = _visible(T, causal)
    for kernel in ("dkv", "dq"):
        seen = np.zeros((T, T), int)  # [query, key]
        owned = []
        for own, blocks in sched[kernel]:
            owned.append(own)
            assert blocks, (kernel, own)
            others = [o for o, _ in blocks]
            assert others == sorted(set(others)), (kernel, own, others)  # each tile once, in order
            r = np.arange(own * rows, (own + 1) * rows)
            for other, masked in blocks:
                c = np.arange(other * cols, (other + 1) * cols)
                qs, ks = (c, r) if kernel == "dkv" else (r, c)
                inside = (qs[:, None] < T) & (ks[None, :] < T)
                block_vis = inside & ((not causal) | (ks[None, :] <= qs[:, None]))
                if not masked:  # the kernel reads every pair of the block as visible
                    assert block_vis.all(), (kernel, own, other)
                qi, ki = np.nonzero(block_vis)
                np.add.at(seen, (qs[qi], ks[ki]), 1)
        assert sorted(owned) == list(range(-(-T // rows))), kernel
        np.testing.assert_array_equal(seen, vis.astype(int), err_msg=kernel)
        if causal:  # the CTAs with the most blocks first
            lens = [len(b) for _, b in sched[kernel]]
            assert lens == sorted(lens, reverse=True), (kernel, lens)


def _inputs(T, D, causal, seed=0, B=1, H=2):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((B, T, H, D)).astype(np.float32))
                   for _ in range(4))
    o, lse = fk.flash_fwd_plain(q, k, v, causal)
    return q, k, v, do, lse, fk.flash_di(o, do)


def _emulate(q, k, v, do, lse, di, causal, rows):
    """The two kernels' arithmetic over bwd_schedule's walk, in the io
    dtype's roundings (f32 here: none). Returns (dK, dV, dQ)."""
    B, T, H, D = q.shape
    cols = fk.BWD_COLS
    dt = q.dtype
    sched = fk.bwd_schedule(T, causal, rows, cols)
    Tp = -(-T // rows) * rows + cols

    def pad(t, dim):
        shape = list(t.shape)
        shape[dim] = Tp - T
        return torch.cat([t.float(), torch.zeros(shape)], dim)

    qp, kp, vp, dop = (pad(t, 1) for t in (q, k, v, do))
    lse2, dip = pad(lse * LOG2E, 2), pad(di, 2)  # [B,H,Tp]
    scale = 1.0 / math.sqrt(D)
    io = lambda t: t.to(dt).float()  # noqa: E731  the kernels' rounding to bf16

    def mask(p, qs, ks):  # p [B,H,len(qs),len(ks)] or transposed by the caller
        ok = (qs[:, None] < T) & (ks[None, :] < T)
        if causal:
            ok &= ks[None, :] <= qs[:, None]
        return p * torch.as_tensor(ok, dtype=p.dtype)

    dk, dv, dq = (torch.zeros(B, Tp, H, D) for _ in range(3))
    for kb, blocks in sched["dkv"]:
        ks = np.arange(kb * rows, (kb + 1) * rows)
        K, V = kp[:, ks], vp[:, ks]
        for qt, masked in blocks:
            qs = np.arange(qt * cols, (qt + 1) * cols)
            Q, dO = qp[:, qs], dop[:, qs]
            s = torch.einsum("bqhd,bkhd->bhqk", Q, K)  # [B,H,cols,rows]
            p = torch.exp2(s * (scale * LOG2E) - lse2[..., qs, None])
            if masked:
                p = mask(p, qs, ks)
            dp = torch.einsum("bqhd,bkhd->bhqk", dO, V)
            ds = (dp - dip[..., qs, None]) * p * scale
            dv[:, ks] += torch.einsum("bhqk,bqhd->bkhd", io(p), dO)
            dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", io(ds), Q)
    for qb, blocks in sched["dq"]:
        qs = np.arange(qb * rows, (qb + 1) * rows)
        Q, dO = qp[:, qs], dop[:, qs]
        for kt, masked in blocks:
            ks = np.arange(kt * cols, (kt + 1) * cols)
            K, V = kp[:, ks], vp[:, ks]
            s = torch.einsum("bqhd,bkhd->bhqk", Q, K)
            p = torch.exp2(s * (scale * LOG2E) - lse2[..., qs, None])
            if masked:
                p = mask(p, qs, ks)
            dp = torch.einsum("bqhd,bkhd->bhqk", dO, V)
            ds = (dp - dip[..., qs, None]) * p * scale
            dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", io(ds), K)
    return dk[:, :T], dv[:, :T], dq[:, :T]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T", T_CASES)
def test_schedule_emulation_matches_plain(T, causal, D, rows):
    q, k, v, do, lse, di = _inputs(T, D, causal, seed=T + D)
    dk, dv, dq = _emulate(q, k, v, do, lse, di, causal, rows)
    want_dk, want_dv = fk.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal)
    want_dq = fk.flash_bwd_dq_plain(q, k, v, do, lse, di, causal)
    if T == 1:  # one key a query: P = 1 and dS = 0, so dK and dQ are noise on both sides
        terms = ((do * v).sum(-1).abs() + di.transpose(1, 2).abs())[..., None] / math.sqrt(D)
        assert float((dk - want_dk).abs().max()) <= TOL * float((terms * q.abs()).max())
        assert float((dq - want_dq).abs().max()) <= TOL * float((terms * k.abs()).max())
        assert _rel(dv, want_dv) <= TOL
        return
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv), ("dq", dq, want_dq)):
        assert _rel(got, want.float()) <= TOL, (name, _rel(got, want.float()))


def test_emulation_fails_where_a_mask_is_left_out():
    """The emulation can fail: with the diagonal blocks left unmasked, each
    key reads the queries before it."""
    T, causal, rows = 100, True, 64
    q, k, v, do, lse, di = _inputs(T, 64, causal)
    real = fk.bwd_schedule.__wrapped__(T, causal, rows, fk.BWD_COLS)
    broken = {"dkv": tuple((kb, tuple((qt, False) for qt, _ in b)) for kb, b in real["dkv"]),
              "dq": real["dq"]}
    orig = fk.bwd_schedule
    fk.bwd_schedule = lambda *a, **kw: broken
    try:
        _, dv, _ = _emulate(q, k, v, do, lse, di, causal, rows)
    finally:
        fk.bwd_schedule = orig
    want_dv = fk.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal)[1]
    assert _rel(dv, want_dv) > 1e3 * TOL


def test_wrappers_size_their_grids_from_the_schedule():
    """The launch's CTA count a head is the schedule's: one CTA for every
    64 rows in the backward kernels, for every 128 in the bf16 forward."""
    for T in T_CASES:
        for causal in (True, False):
            s = fk.bwd_schedule(T, causal)
            assert len(s["dkv"]) == len(s["dq"]) == -(-T // fk.BWD_ROWS)
            assert len(fk.q_schedule(T, causal, fk.FWD_ROWS)) == -(-T // 128)


def _emulate_fwd(q, k, v, causal, rows, sched=None):
    """flash_fwd_tc_kernel's arithmetic over q_schedule's walk (or `sched`),
    in the io dtype's rounding of P (f32 here: none). Returns (O, LSE)."""
    B, T, H, D = q.shape
    cols = fk.FLASH_BLOCK
    dt = q.dtype
    sched = fk.q_schedule(T, causal, rows, cols) if sched is None else sched
    Tp = -(-T // rows) * rows + cols

    def pad(t):
        return torch.cat([t.float(), torch.zeros(B, Tp - T, H, D)], 1)

    qp, kp, vp = pad(q), pad(k), pad(v)
    scale_log2 = LOG2E / math.sqrt(D)
    o = torch.zeros(B, Tp, H, D)
    lse = torch.zeros(B, H, Tp)
    for qb, blocks in sched:
        qs = np.arange(qb * rows, (qb + 1) * rows)
        m = torch.full((B, H, rows, 1), float("-inf"))
        l = torch.zeros(B, H, rows, 1)
        acc = torch.zeros(B, H, rows, D)
        for kt, masked in blocks:
            ks = np.arange(kt * cols, (kt + 1) * cols)
            s = torch.einsum("bqhd,bkhd->bhqk", qp[:, qs], kp[:, ks]) * scale_log2
            if masked:
                ok = np.ones((rows, 1), bool) & (ks[None, :] < T)
                if causal:
                    ok = ok & (ks[None, :] <= qs[:, None])
                s = s.masked_fill(~torch.as_tensor(ok), float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), vp[:, ks])
            m = m_new
        o[:, qs] = (acc * (1.0 / l)).permute(0, 2, 1, 3)
        lse[..., qs] = (m * math.log(2.0) + torch.log(l))[..., 0]
    return o[:, :T], lse[..., :T]


def _fwd_rel(got, want):
    o, lse = got
    wo, wl = want
    return _rel(o, wo.float()), float((lse - wl).abs().max() / wl.abs().max())


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T", T_CASES)
def test_forward_emulation_matches_plain(T, causal, D, rows):
    q, k, v = _inputs(T, D, causal, seed=2 * T + D)[:3]
    err_o, err_lse = _fwd_rel(_emulate_fwd(q, k, v, causal, rows), fk.flash_fwd_plain(q, k, v, causal))
    assert err_o <= TOL and err_lse <= TOL, (err_o, err_lse)


@pytest.mark.parametrize("T", [100, 129])
def test_forward_emulation_fails_where_a_mask_is_left_out(T):
    """The forward's emulation can fail: with the flagged blocks left
    unmasked, causal rows read later keys (and past T, zero-filled keys)."""
    causal, rows = True, 64
    q, k, v = _inputs(T, 64, causal)[:3]
    broken = tuple((qb, tuple((kt, False) for kt, _ in b))
                   for qb, b in fk.q_schedule(T, causal, rows))
    err_o, _ = _fwd_rel(_emulate_fwd(q, k, v, causal, rows, sched=broken),
                        fk.flash_fwd_plain(q, k, v, causal))
    assert err_o > 1e3 * TOL


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T", T_CASES)
def test_q_schedule_is_the_dq_walk(T, causal):
    """The forward's walk is the dQ kernel's: each query block once,
    heaviest first, key tiles of FLASH_BLOCK from 0, the same flags."""
    assert fk.FLASH_BLOCK == fk.BWD_COLS
    assert fk.q_schedule(T, causal) == fk.bwd_schedule(T, causal)["dq"]
    assert len(fk.q_schedule(T, causal)) == -(-T // fk.BWD_ROWS)
