"""The bf16 whole-sequence decoder kernels' partition on the CPU, where no
kernel runs: the backward's (B10, csrc/decoder_seq.cu
`decoder_seq_bwd_tc_kernel`, and its post-walk pass on B7's kernel,
csrc/bahdanau_attn.cu `attn_dep_kernel`)
layout, an emulation of its walk, and its d(enc_proj)/dv pass; the
forward's (B9, `decoder_seq_fwd_tc_kernel`) the same, and the route rules.

- The partition (`_partition`, this file's copy of the kernel's indexing,
  and `_groups`, of `tcb::plan`'s batch groups) hands every (row, unit)
  pair, every element of dctx and every row's attention to exactly one
  CTA, at bench widths with the
  plan's batch groups for a 132-SM card, at chip_smoke.py's SEQ_EDGE
  shapes and across a batch-group border (B = 64, 65).
- An emulation of the walk, step by step as the CTAs compute it: the gate
  math in f32 op by op, du, dc, dr, dctx and ddp rounded to the io dtype
  where the kernel publishes them into its exchanges (padded to whole 16s
  of units and of A, the padding zero), each product's k16 pieces summed
  in f32 in k order (`_k16`), the dur·w_urᵀ product carried from its du
  part into its dr part, dh carried in f32, and d(enc_proj)/dv after the
  walk by `decoder_seq_dep_plain`. It is held to `decoder_seq_bwd_plain`
  and to the JAX package's `_decoder_seq_bwd` in interpret mode, f32 and
  bf16, with tests/test_torch_seq2seq.py's `_assert_kernel_close` bounds
  as they are, on inputs with ragged source and target masks and a row
  that never steps, and at T = 1; and to the plain version alone at the
  SEQ_EDGE widths (C = 130, 520; A = 100, 128, 300; H = 100, 301, 700),
  there in bf16 with chip_smoke.py's bounds (see _EDGE_SHARE).
- The post-walk pass's plain version, fed the walk's own dsc, gives
  `decoder_seq_bwd_plain`'s dep and dv bit for bit: the same terms summed
  in the same order, newest step first; so does the emulation of the
  card's pass (B7's walk over the nonzero terms, newest first:
  test_torch_attention._dep_walk) for dep, its dv within 1e-5 of Σ|dsc|.
- The forward's partition (`_fwd_partition`, this file's copy of its
  indexing): every (row, unit) pair, every element of dp and every row's
  attention to one CTA. Its weights' layout (`seq_fwd_weights`). An
  emulation of its walk (`_partition_fwd`: dp, the gate products and the
  candidate's from staged exchanges in k16 pieces summed in f32 in k
  order, each rounding at the kernel's place, the attention by the row
  routine's emulation `_rows_attention` on the products' ring), held to
  `decoder_seq_fwd_plain` and to the JAX package's `_decoder_seq_fwd` in
  interpret mode (ragged, T = 1; f32 and bf16) and to the plain version at
  two SEQ_EDGE widths, under chip_smoke.py's SEQ bounds (`_seq_bounds`);
  with xp rounded once instead of twice it fails them. The route rules
  (`seq_fwd_route`, `row_path`) as functions of the shape.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu.ops import bahdanau_kernels as bk  # noqa: E402
from paddle_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from test_torch_attention import _dep_walk, _rows_attention  # noqa: E402
from test_torch_seq2seq import (_assert_kernel_close, _jit, _seq_case,  # noqa: E402
                                _to_jax)

_OUT = ("dxp", "dctx", "ddp", "dh0", "dep", "dv")
# chip_smoke.py's SEQ_EDGE, (B, S, T, E, C, A, H)
_SEQ_EDGE = [(5, 7, 4, 16, 130, 100, 100), (3, 45, 5, 24, 520, 300, 301),
             (4, 9, 3, 16, 130, 128, 700)]


# --------------------------------------------------------------- layout --
def _groups(n_tiles, n_ug, cap):
    """The plan's batch groups and sub-tiles a group, for a card that holds
    `cap` CTAs at once: as many groups beside the n_ug unit groups as fit,
    none empty (tcb::plan in csrc/decoder_seq.cu)."""
    groups = min(n_tiles, cap // n_ug)
    tpg = -(-n_tiles // groups)
    return -(-n_tiles // tpg), tpg


def _partition(B, A, C, H, tiles_per_group):
    """What each CTA (x, y) of the bf16 backward owns, as
    tcb::decoder_seq_bwd_tc_kernel indexes it: the (row, unit) pairs whose
    gate math and carry it computes, the (row, column) elements of dctx it
    publishes, the rows whose attention (dsc over S) it computes, and the
    (row, column) elements of ddp it publishes (every column of A of those
    rows)."""
    lay = ak.seq_layout(B, A, C, H)
    n_ug, cs = lay["n_ug"], lay["cs"]
    groups = -(-lay["n_tiles"] // tiles_per_group)
    owns = {}
    for y in range(groups):
        tile0 = y * tiles_per_group
        n_mine = min(lay["n_tiles"], tile0 + tiles_per_group) - tile0
        rows = [b for b in range(tile0 * ak.SEQ_ROWS, (tile0 + n_mine) * ak.SEQ_ROWS) if b < B]
        for x in range(n_ug):
            units = range(x * ak.SEQ_UNITS, (x + 1) * ak.SEQ_UNITS)
            owns[(x, y)] = dict(
                pairs=[(b, j) for b in rows for j in units if j < H],
                dctx=[(b, c) for b in rows for c in range(x * cs, (x + 1) * cs) if c < C],
                attention=[b for li, b in enumerate(rows) if li % n_ug == x])
            owns[(x, y)]["ddp"] = [(b, a) for b in owns[(x, y)]["attention"] for a in range(A)]
    return owns


@pytest.mark.parametrize("B,A,C,H", [(256, 512, 1024, 512), (64, 512, 1024, 512),
                                     (65, 512, 1024, 512), (520, 512, 1024, 512),
                                     *[(b, a, c, h) for b, _, _, _, c, a, h in _SEQ_EDGE]])
def test_partition_takes_every_pair_column_and_row_once(B, A, C, H):
    """Every (row, unit) pair, dctx element, attention row and ddp element
    (every column of C and of A for every row) to one CTA,
    with the batch groups the plan takes on a 132-SM card at one CTA an
    SM; the C slices fit the kernel's n-tiles."""
    lay = ak.seq_layout(B, A, C, H)
    assert lay["cs"] % 8 == 0 and lay["cs"] <= ak.SEQ_MAX_SLICE
    assert lay["n_ug"] * lay["cs"] >= C
    groups, tpg = _groups(lay["n_tiles"], lay["n_ug"], 132)
    assert groups * lay["n_ug"] <= 132 and (groups - 1) * tpg < lay["n_tiles"] <= groups * tpg
    owns = _partition(B, A, C, H, tpg)
    assert len(owns) == groups * lay["n_ug"]
    for key, every in (("pairs", [(b, j) for b in range(B) for j in range(H)]),
                       ("dctx", [(b, c) for b in range(B) for c in range(C)]),
                       ("attention", list(range(B))),
                       ("ddp", [(b, a) for b in range(B) for a in range(A)])):
        taken = sorted(x for o in owns.values() for x in o[key])
        assert taken == every, key
    if (B, H) == (256, 512):  # the step's shape: 4 groups of 2 sub-tiles, 128 CTAs
        assert (groups, tpg, lay["cs"]) == (4, 2, 32)
        assert all(len(o["attention"]) == 2 for o in owns.values())


def test_weights_rows_are_the_products_columns():
    """seq_bwd_weights: row j of wu is unit j's [w_u | w_r | w_c] with gate
    q at q·Hp, row j of wad unit j's wa_dec, row c of wxc wx_c's row c with
    its gates at q·Hp; the padding zero. So x·rowᵀ over the padded exchange
    is the plain version's product (float64)."""
    rng = np.random.RandomState(3)
    H, A, C, B = 20, 30, 50, 4
    w_c, w_ur = torch.as_tensor(rng.randn(H, H)), torch.as_tensor(rng.randn(H, 2 * H))
    wx_c, wa_dec = torch.as_tensor(rng.randn(C, 3 * H)), torch.as_tensor(rng.randn(H, A))
    wu, wad, wxc = ak.seq_bwd_weights(w_c, w_ur, wx_c, wa_dec)
    lay = ak.seq_layout(B, A, C, H)
    Hp, Ap = lay["Hp"], lay["Ap"]
    assert wu.shape == (Hp, 3 * Hp) and wad.shape == (Hp, Ap)
    assert wxc.shape == (lay["n_ug"] * lay["cs"], 3 * Hp)
    dxp = torch.as_tensor(rng.randn(B, 3 * H))
    ex = torch.zeros(B, 3 * Hp, dtype=dxp.dtype)
    for q in range(3):
        ex[:, q * Hp:q * Hp + H] = dxp[:, q * H:(q + 1) * H]
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-12)  # noqa: E731
    close((ex @ wxc.T)[:, :C], dxp @ wx_c.T)
    close((ex[:, :2 * Hp] @ wu[:, :2 * Hp].T)[:, :H], dxp[:, :2 * H] @ w_ur.T)
    close((ex[:, 2 * Hp:] @ wu[:, 2 * Hp:].T)[:, :H], dxp[:, 2 * H:] @ w_c.T)
    ddp = torch.as_tensor(rng.randn(B, A))
    dex = torch.zeros(B, Ap, dtype=ddp.dtype)
    dex[:, :A] = ddp
    close((dex @ wad.T)[:, :H], ddp @ wa_dec.T)
    assert float(wxc[C:].abs().sum()) == 0 and float(wu[H:].abs().sum()) == 0


# ------------------------------------------------------------ the walk --
def _k16(a, rows, acc=None):
    """a [R, K] times rows [N, K]ᵀ as the kernel's warps sum it: each k16
    piece's product a fragment of its own, added in f32 in k order to acc
    (zeros if None)."""
    R, K = a.shape
    parts = torch.einsum("rks,nks->krn", a.reshape(R, K // 16, 16),
                         rows.reshape(rows.shape[0], K // 16, 16))
    acc = torch.zeros(R, rows.shape[0]) if acc is None else acc
    for p in parts:
        acc = acc + p
    return acc


def _partition_bwd(ep, enc, mask, g, tmask, hp_seq, u_seq, r_seq, c_seq, dp_seq, alpha, v,
                   w_c, w_ur, wx_c, wa_dec):
    """decoder_seq_bwd_plain's function as decoder_seq_bwd_tc_kernel walks
    it (see the module's note); a CTA's outputs depend on its rows of the
    exchanges and its columns of the weights only, so the walk computes
    every CTA at once. Returns the six outputs."""
    dt = hp_seq.dtype
    T, B, H = hp_seq.shape
    S, A, C = ep.shape[1], ep.shape[2], enc.shape[2]
    lay = ak.seq_layout(B, A, C, H)
    Hp, Ap = lay["Hp"], lay["Ap"]
    wu, wad, wxc = (w.float() for w in ak.seq_bwd_weights(w_c, w_ur, wx_c, wa_dec))
    io = lambda x: x.to(dt).float()  # noqa: E731
    dh = torch.zeros(B, H)
    dxps, dctxs, ddps = [None] * T, [None] * T, [None] * T
    dsc_seq = torch.zeros(T, B, S)
    for t in range(T - 1, -1, -1):
        u, r, c, hp = (x[t].float() for x in (u_seq, r_seq, c_seq, hp_seq))
        m = tmask[t][:, None]
        # (A)
        dh = dh + g[t].float()
        dh_cell = dh * m
        run = dh * (1.0 - m) + dh_cell * (1.0 - u)
        du = dh_cell * (c - hp)
        duq, dcq = io(du * u * (1.0 - u)), io(dh_cell * u * (1.0 - c * c))
        ex = torch.zeros(B, 3 * Hp)
        ex[:, :H], ex[:, 2 * Hp:2 * Hp + H] = duq, dcq
        # (B)
        drh = _k16(ex[:, 2 * Hp:], wu[:, 2 * Hp:])[:, :H]
        du_part = _k16(ex[:, :Hp], wu[:, :Hp])
        drq = io(drh * hp * r * (1.0 - r))
        ex[:, Hp:Hp + H] = drq
        run = run + drh * r
        # (C)
        dh_prev = run + _k16(ex[:, Hp:2 * Hp], wu[:, Hp:2 * Hp], du_part)[:, :H]
        dctx = io(_k16(ex, wxc)[:, :C])
        # (D)
        dalpha = torch.bmm(enc.float(), dctx[:, :, None])[..., 0]
        al = alpha[t]
        dsc = al * (dalpha - (al * dalpha).sum(-1, keepdim=True))
        dsc = torch.where(mask > 0, dsc, torch.zeros(()))
        th = torch.tanh(ep.float() + dp_seq[t].float()[:, None, :])
        ddp = io((dsc[:, :, None] * (1.0 - th * th)).sum(1) * v.float())
        dex = torch.zeros(B, Ap)
        dex[:, :A] = ddp
        # (E)
        dh = dh_prev + _k16(dex, wad)[:, :H]
        dxps[t] = torch.cat([duq, drq, dcq], -1).to(dt)
        dctxs[t], ddps[t], dsc_seq[t] = dctx.to(dt), ddp.to(dt), dsc
    dep, dv = ak.decoder_seq_dep_plain(ep, dp_seq, dsc_seq, v)
    return torch.stack(dxps), torch.stack(dctxs), torch.stack(ddps), dh.to(dt), dep, dv


def _case_t1(dtype):
    """_seq_case's inputs cut to the last target step: T = 1."""
    _, bwd, _ = _seq_case(dtype, seed=2)
    tmask = bwd[4][-1:].clone()
    tmask[0, 1] = 0.0  # a row that never steps
    return tuple(x[-1:] if i in (3, 5, 6, 7, 8, 9, 10) else tmask if i == 4 else x
                 for i, x in enumerate(bwd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "T=1"])
def test_partition_walk_matches_plain_and_pallas(case, dtype):
    bwd = _seq_case(dtype, seed=1)[1] if case == "ragged" else _case_t1(dtype)
    got = _partition_bwd(*bwd)
    plain = ak.decoder_seq_bwd_plain(*bwd)
    S = bwd[0].shape[1]
    want = _jit(lambda *a: bk._decoder_seq_bwd(*a, jnp.dtype(dtype), True))(
        *_to_jax(bwd, dtype, {0: 1, 1: 1, 2: 1, 10: 2}))
    for name, g, p, w in zip(_OUT, got, plain, want):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        w = np.asarray(w, np.float32)
        _assert_kernel_close(name, g, w[:, :S] if name == "dep" else w.reshape(g.shape), dtype)
        _assert_kernel_close(name, g, p.float().numpy(), dtype)
    # rows that never step: nothing reaches their cells
    never = [b for b in range(bwd[4].shape[1]) if float(bwd[4][:, b].sum()) == 0]
    assert never and all(torch.all(got[0][:, b] == 0) for b in never)


# At these widths the walk's k16-ordered sums (3H = 2100 terms at H = 700)
# and the plain version's round more bf16 outputs apart than at the
# JAX-legal widths above (0.56% of dxp at H = 700, B = 4, a few of them two
# ulps, where the f32 dh carries differ in their last bits): held, as
# chip_smoke.py holds the kernel at these shapes on the card, to at most
# SEQ_BEYOND_ULP of each io output beyond one ulp, and ddp, dep and dv (sums
# that cancel) beyond one ulp within 1e-2 of their largest element.
_EDGE_SHARE = 0.10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SEQ_EDGE, ids=lambda s: "B{}-C{}-A{}-H{}".format(*s[:1], *s[4:]))
def test_partition_walk_matches_plain_at_edge_widths(shape, dtype):
    """The walk at widths that are no whole 16s of units or of A, slices of
    C that do not divide, S past one warp, a row that never steps: against
    the plain version (f32 within 1e-5 of each output's largest element;
    bf16 with chip_smoke.py's bounds, _EDGE_SHARE's note)."""
    B, S, T, E, C, A, H = shape
    rng = np.random.RandomState(B + C + H)
    dt = getattr(torch, dtype)
    f = lambda *s, sc=1.0: torch.as_tensor(sc * rng.standard_normal(s), dtype=torch.float32)  # noqa
    lens, tlens = rng.randint(1, S + 1, size=B), rng.randint(1, T + 1, size=B)
    lens[0], tlens[0], tlens[-1] = S, T, 0
    mask = torch.as_tensor(np.arange(S)[None] < lens[:, None], dtype=torch.float32)
    tmask = torch.as_tensor(np.arange(T)[:, None] < tlens[None], dtype=torch.float32)
    alpha = torch.softmax(torch.where(mask > 0, f(T, B, S), torch.tensor(-1e9)), -1)
    io = [f(B, S, A), f(B, S, C, sc=0.5), f(T, B, H, sc=0.1), f(T, B, H, sc=0.5),
          torch.sigmoid(f(T, B, H)), torch.sigmoid(f(T, B, H)), torch.tanh(f(T, B, H)),
          f(T, B, A, sc=0.5), f(A, sc=A ** -0.5), f(H, H, sc=H ** -0.5),
          f(H, 2 * H, sc=H ** -0.5), f(C, 3 * H, sc=C ** -0.5), f(H, A, sc=H ** -0.5)]
    ep, enc, g, hp, u, r, c, dp, v, w_c, w_ur, wx_c, wa_dec = (x.to(dt) for x in io)
    bwd = (ep, enc, mask, g, tmask, hp, u, r, c, dp, alpha, v, w_c, w_ur, wx_c, wa_dec)
    got, plain = _partition_bwd(*bwd), ak.decoder_seq_bwd_plain(*bwd)
    for name, a, b in zip(_OUT, got, plain):
        a, b = a.float().numpy(), b.float().numpy()
        d, scale = np.abs(a - b), float(np.abs(b).max())
        if dtype == "float32":
            assert d.max() <= 1e-5 * scale, (name, d.max() / scale)
            continue
        beyond = d - 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
        if name in ("ddp", "dep", "dv"):
            assert beyond.max() <= 1e-2 * scale, (name, beyond.max() / scale)
        else:
            assert np.mean(beyond > 0) <= _EDGE_SHARE, (name, np.mean(beyond > 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_walk_pass_gives_the_plain_dep_and_dv_bit_for_bit(dtype):
    """decoder_seq_dep_plain fed the plain walk's own dsc (recomputed from
    its dctx as the walk computes it) gives decoder_seq_bwd_plain's dep and
    dv bit for bit; the CPU wrapper runs it and launches nothing."""
    bwd = _seq_case(dtype, seed=4)[1]
    ep, enc, mask, alpha = bwd[0], bwd[1], bwd[2], bwd[10]
    out = ak.decoder_seq_bwd_plain(*bwd)
    dsc = torch.zeros(alpha.shape)
    for t in range(alpha.shape[0]):
        dal = torch.bmm(enc.float(), out[1][t].float()[:, :, None])[..., 0]
        d = alpha[t] * (dal - (alpha[t] * dal).sum(-1, keepdim=True))
        dsc[t] = torch.where(mask > 0, d, torch.zeros((), device=d.device))
    before = ak.decoder_seq_dep_launches
    dep, dv = ak.decoder_seq_dep(ep, bwd[9], dsc, bwd[11])
    assert ak.decoder_seq_dep_launches == before
    assert dep.dtype == ep.dtype and dv.dtype == torch.float32
    assert torch.equal(dep, out[4]) and torch.equal(dv, out[5])
    assert float(dep.float().abs().max()) > 0 and float(dv.abs().max()) > 0
    # the card's pass, B7's walk newest first (test_torch_attention._dep_walk):
    # every nonzero term once, dep bit for bit, dv in its fixed order
    walk, walk_dv, taken = _dep_walk(ep, bwd[9], dsc, bwd[11], newest=True)
    assert taken == int((dsc != 0).sum()) and torch.equal(walk, out[4])
    assert float((walk_dv - out[5]).abs().max()) <= 1e-5 * float(dsc.abs().sum())


# --------------------------------------------------- the bf16 forward (B9) --
def _fwd_partition(B, A, C, H, tiles_per_group):
    """What each CTA (x, y) of the bf16 forward owns, as
    tcb::decoder_seq_fwd_tc_kernel indexes it: the (row, unit) pairs whose
    gates and cell it computes, the (row, column) elements of dp it
    publishes (its slice of `as` columns, those below A), and the rows
    whose attention it computes (row i of the group to CTA i mod n_ug)."""
    lay = ak.seq_layout(B, A, C, H)
    n_ug, as_ = lay["n_ug"], lay["as"]
    groups = -(-lay["n_tiles"] // tiles_per_group)
    owns = {}
    for y in range(groups):
        tile0 = y * tiles_per_group
        n_mine = min(lay["n_tiles"], tile0 + tiles_per_group) - tile0
        rows = [b for b in range(tile0 * ak.SEQ_ROWS, (tile0 + n_mine) * ak.SEQ_ROWS) if b < B]
        for x in range(n_ug):
            units = range(x * ak.SEQ_UNITS, (x + 1) * ak.SEQ_UNITS)
            owns[(x, y)] = dict(
                pairs=[(b, j) for b in rows for j in units if j < H],
                dp=[(b, a) for b in rows for a in range(x * as_, (x + 1) * as_) if a < A],
                attention=[b for li, b in enumerate(rows) if li % n_ug == x])
    return owns


@pytest.mark.parametrize("B,A,C,H", [(256, 512, 1024, 512), (64, 512, 1024, 512),
                                     (65, 512, 1024, 512),
                                     *[(b, a, c, h) for b, _, _, _, c, a, h in _SEQ_EDGE]])
def test_fwd_partition_takes_every_pair_column_and_row_once(B, A, C, H):
    """Every (row, unit) pair, every element of dp (every column of A of
    every row) and every row's attention to one CTA, with the batch groups
    the plan takes on a 132-SM card; the slices of A fit the kernel's
    n-tiles."""
    lay = ak.seq_layout(B, A, C, H)
    assert lay["as"] % 8 == 0 and lay["as"] <= ak.SEQ_MAX_AS and lay["n_ug"] * lay["as"] >= A
    groups, tpg = _groups(lay["n_tiles"], lay["n_ug"], 132)
    owns = _fwd_partition(B, A, C, H, tpg)
    assert len(owns) == groups * lay["n_ug"] <= 132
    for key, every in (("pairs", [(b, j) for b in range(B) for j in range(H)]),
                       ("dp", [(b, a) for b in range(B) for a in range(A)]),
                       ("attention", list(range(B)))):
        taken = sorted(x for o in owns.values() for x in o[key])
        assert taken == every, key
    if (B, H) == (256, 512):  # the step's shape: 4 groups of 2 sub-tiles, 128 CTAs
        assert (groups, tpg, lay["as"]) == (4, 2, 16)
        assert all(len(o["attention"]) == 2 for o in owns.values())


def test_fwd_weights_rows_are_the_products_columns():
    """seq_fwd_weights: row 48x + 16q + i of wg is gate q's column of unit
    16x + i (u, r of w_ur; c of w_c), of wx the same of wx_c, row a of wa
    wa_dec's column a; the padding zero. So x·rowᵀ over the padded operand
    is the plain version's product (float64)."""
    rng = np.random.RandomState(5)
    H, A, C, B = 20, 30, 50, 4
    w_c, w_ur = torch.as_tensor(rng.randn(H, H)), torch.as_tensor(rng.randn(H, 2 * H))
    wx_c, wa_dec = torch.as_tensor(rng.randn(C, 3 * H)), torch.as_tensor(rng.randn(H, A))
    wg, wx, wa = ak.seq_fwd_weights(wa_dec, wx_c, w_ur, w_c)
    lay = ak.seq_layout(B, A, C, H)
    Hp, Cp, n_ug = lay["Hp"], lay["Cp"], lay["n_ug"]
    assert wg.shape == (n_ug * 48, Hp) and wx.shape == (n_ug * 48, Cp)
    assert wa.shape == (n_ug * lay["as"], Hp)
    h, ctx = torch.zeros(B, Hp, dtype=torch.float64), torch.zeros(B, Cp, dtype=torch.float64)
    h[:, :H], ctx[:, :C] = torch.as_tensor(rng.randn(B, H)), torch.as_tensor(rng.randn(B, C))
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-12)  # noqa: E731
    gates = lambda w, x: (x @ w.T).reshape(B, n_ug, 3, 16).transpose(1, 2).reshape(B, 3, Hp)  # noqa
    g, gx = gates(wg, h), gates(wx, ctx)
    close(g[:, 0, :H], h[:, :H] @ w_ur[:, :H])
    close(g[:, 1, :H], h[:, :H] @ w_ur[:, H:])
    close(g[:, 2, :H], h[:, :H] @ w_c)
    close(gx.reshape(B, 3, Hp)[:, :, :H].reshape(B, 3 * H), ctx[:, :C] @ wx_c)
    close((h @ wa.T)[:, :A], h[:, :H] @ wa_dec)
    assert float(wa[A:].abs().sum()) == 0 and float(g[:, :, H:].abs().sum()) == 0


def _partition_fwd(ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c, xp_once=False):
    """decoder_seq_fwd_plain's function as decoder_seq_fwd_tc_kernel walks
    it (see csrc/decoder_seq.cu's note): (1) dp = h·wa f32 and io(h·w_u),
    io(h·w_r) from the staged h exchange, (2) the row routine on the stage
    of the products' ring, ctx into a padded exchange, (3) xp = io(xpx +
    io(ctx·wx_c)), u and r by the op-by-op sigmoid, io(r·h) published, (4)
    c = tanh(io(xp_c + io(rh·w_c))), h' and the masked carry, each rounded
    where the kernel rounds, each product's k16 pieces summed in f32 in k
    order (`_k16`). xp_once: xp rounded once (io(xpx + ctx·wx_c)), a
    misplaced rounding the bf16 bound must catch. Returns (h_seq, alpha,
    ctx)."""
    dt = h0.dtype
    T, B = xpx.shape[:2]
    H = h0.shape[1]
    S, A, C = ep.shape[1], ep.shape[2], enc.shape[2]
    lay = ak.seq_layout(B, A, C, H)
    Hp, Cp, n_ug = lay["Hp"], lay["Cp"], lay["n_ug"]
    wg, wx, wa = (w.float() for w in ak.seq_fwd_weights(wa_dec, wx_c, w_ur, w_c))
    gate = lambda w, q: w.reshape(n_ug, 3, ak.SEQ_UNITS, -1)[:, q].reshape(Hp, -1)  # noqa: E731
    io = lambda x: x.to(dt).float()  # noqa: E731
    sig = lambda x: io(1.0 / io(1.0 + io(torch.exp(-x))))  # noqa: E731
    h = torch.zeros(B, Hp)
    h[:, :H] = h0.float()
    hs, alphas, ctxs = [], [], []
    for t in range(T):
        # (1)
        dp = _k16(h, wa)[:, :A]
        hu, hr = io(_k16(h, gate(wg, 0))), io(_k16(h, gate(wg, 1)))
        # (2)
        ctx, alpha = _rows_attention(ep, enc, dp, v, mask, ak.SEQ_RING_BYTES)
        cx = torch.zeros(B, Cp)
        cx[:, :C] = ctx.float()
        # (3)
        x = xpx[t].float()
        xp = [(io(x[:, q * H:(q + 1) * H] + _k16(cx, gate(wx, q))[:, :H]) if xp_once else
               io(x[:, q * H:(q + 1) * H] + io(_k16(cx, gate(wx, q))[:, :H]))) for q in range(3)]
        u, r = sig(io(xp[0] + hu[:, :H])), sig(io(xp[1] + hr[:, :H]))
        rh = torch.zeros(B, Hp)
        rh[:, :H] = io(r * h[:, :H])
        # (4)
        c = io(torch.tanh(io(xp[2] + io(_k16(rh, gate(wg, 2))[:, :H]))))
        hp = h[:, :H]
        hn = io(io(io(1.0 - u) * hp) + io(u * c))
        m = io(tmask[t][:, None])
        h = h.clone()
        h[:, :H] = io(io(m * hn) + io(io(1.0 - m) * hp))
        hs.append(h[:, :H].to(dt))
        alphas.append(alpha)
        ctxs.append(ctx)
    return torch.stack(hs), torch.stack(alphas), torch.stack(ctxs)


_FWD_OUT = ("h_seq", "alpha", "ctx")


def _seq_bounds(name, got, want, dtype):
    """chip_smoke.py's SEQ bounds (SEQ_TOL's note): f32 within 1e-5 of the
    output's largest element; bf16 at most SEQ_BEYOND_ULP (10%) of an io
    output beyond one ulp of the reference, an f32 output (alpha) beyond
    one ulp within 1e-2 of its largest. Returns the reading."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    d, scale = np.abs(got - want), float(np.abs(want).max())
    if dtype == "float32":
        assert d.max() <= 1e-5 * scale, (name, d.max() / scale)
        return d.max() / scale
    if name == "alpha":
        assert d.max() <= 1e-2 * scale, (name, d.max() / scale)
        return d.max() / scale
    share = float(np.mean(d > 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)))
    assert share <= _EDGE_SHARE, (name, share)
    return share


def _fwd_case_t1(dtype):
    """_seq_case's forward inputs cut to the first target step: T = 1, a
    row that never steps."""
    fwd = _seq_case(dtype, seed=6)[0]
    tmask = fwd[4][:1].clone()
    tmask[0, 1] = 0.0
    return tuple(x[:1] if i == 3 else tmask if i == 4 else x for i, x in enumerate(fwd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "T=1"])
def test_fwd_walk_matches_plain_and_pallas(case, dtype):
    """The walk against decoder_seq_fwd_plain and the JAX package's
    `_decoder_seq_fwd` in interpret mode, on ragged source and target masks
    with a row that never steps, and at T = 1."""
    fwd = _seq_case(dtype, seed=5)[0] if case == "ragged" else _fwd_case_t1(dtype)
    got = _partition_fwd(*fwd)
    plain = ak.decoder_seq_fwd_plain(*fwd)
    S = fwd[0].shape[1]
    want = _jit(lambda *a: bk._decoder_seq_fwd(*a, True))(*_to_jax(fwd, dtype, {0: 1, 1: 1, 2: 1}))
    for name, g, p, w in zip(_FWD_OUT, got, plain, want):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        w = np.asarray(w, np.float32)
        _seq_bounds(name, g, w[..., :S] if name == "alpha" else w, dtype)
        _seq_bounds(name, g, p.float().numpy(), dtype)
    never = [b for b in range(fwd[4].shape[1]) if float(fwd[4][:, b].sum()) == 0]
    assert never and all(torch.equal(got[0][:, b], fwd[5][b].expand_as(got[0][:, b]))
                         for b in never)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SEQ_EDGE[:2], ids=lambda s: "B{}-C{}-A{}-H{}".format(*s[:1], *s[4:]))
def test_fwd_walk_matches_plain_at_edge_widths(shape, dtype):
    """The walk at widths that are no whole 16s of units or of C, rows the
    row routine copies by plain loads, S past one warp, a row that never
    steps: against the plain version under the SEQ bounds."""
    B, S, T, E, C, A, H = shape
    rng = np.random.RandomState(B + C + H + 1)
    dt = getattr(torch, dtype)
    f = lambda *s, sc=1.0: torch.as_tensor(sc * rng.standard_normal(s), dtype=torch.float32)  # noqa
    lens, tlens = rng.randint(1, S + 1, size=B), rng.randint(1, T + 1, size=B)
    lens[0], tlens[0], tlens[-1] = S, T, 0
    mask = torch.as_tensor(np.arange(S)[None] < lens[:, None], dtype=torch.float32)
    tmask = torch.as_tensor(np.arange(T)[:, None] < tlens[None], dtype=torch.float32)
    io = [f(B, S, A), f(B, S, C, sc=0.5), f(T, B, 3 * H, sc=0.5), f(B, H, sc=0.5),
          f(H, A, sc=H ** -0.5), f(A, sc=A ** -0.5), f(C, 3 * H, sc=C ** -0.5),
          f(H, 2 * H, sc=H ** -0.5), f(H, H, sc=H ** -0.5)]
    ep, enc, xpx, h0, wa_dec, v, wx_c, w_ur, w_c = (x.to(dt) for x in io)
    fwd = (ep, enc, mask, xpx, tmask, h0, wa_dec, v, wx_c, w_ur, w_c)
    assert ak.row_path(A, C) == ak.ATTN_LOADS
    for name, g, p in zip(_FWD_OUT, _partition_fwd(*fwd), ak.decoder_seq_fwd_plain(*fwd)):
        _seq_bounds(name, g, p.float().numpy(), dtype)


def test_fwd_walk_with_xp_rounded_once_fails_the_share_bound():
    """A control: the walk with xp rounded once instead of twice lies more
    than one ulp from the plain version in more than the bf16 bound's 10%
    of h_seq, so the bound tells a misplaced rounding from the kernel's
    sound flips."""
    fwd = _seq_case("bfloat16", seed=5)[0]
    plain = ak.decoder_seq_fwd_plain(*fwd)[0].float().numpy()
    good = _seq_bounds("h_seq", _partition_fwd(*fwd)[0], plain, "bfloat16")
    with pytest.raises(AssertionError):
        _seq_bounds("h_seq", _partition_fwd(*fwd, xp_once=True)[0], plain, "bfloat16")
    assert good <= _EDGE_SHARE


# ------------------------------------------------------------- the routes --
def test_route_rules_are_functions_of_the_shape():
    """seq_fwd_route: every bf16 shape chip_smoke.py runs (the main path's,
    SEQ_EDGE's, B = 64, 65) on the tensor-core forward, f32 and the shapes
    its plan cannot place (a slice of A past 64 columns, C past the row
    routine's 8192 or past what a half of the ring stages, more unit groups
    than a 132-SM card holds) on the first
    design; row_path: bulk copies for rows of a multiple of 16 bytes."""
    bf, f32 = torch.bfloat16, torch.float32
    for B, S, _, _, C, A, H in [(256, 50, 50, 512, 1024, 512, 512), (64, 20, 6, 32, 1024, 512, 512),
                                (65, 20, 6, 32, 1024, 512, 512), *_SEQ_EDGE]:
        assert ak.seq_fwd_route(B, S, A, C, H, bf) == ak.SEQ_TC
        assert ak.seq_fwd_route(B, S, A, C, H, f32) == ak.FIRST
    assert ak.seq_fwd_route(8, 10, 512, 256, 16, bf) == ak.FIRST      # as = 512 > 64
    assert ak.seq_fwd_route(8, 10, 128, 9000, 128, bf) == ak.FIRST    # C past 8192
    assert ak.seq_fwd_route(8, 10, 128, 256, 2200, bf) == ak.FIRST    # 138 unit groups
    assert ak.seq_fwd_route(8, 10, 128, 6912, 128, bf) == ak.SEQ_TC    # a ring half holds 2 rows
    assert ak.seq_fwd_route(8, 10, 128, 6920, 128, bf) == ak.FIRST    # it does not
    assert ak.row_path(512, 1024) == ak.ATTN_BULK
    assert ak.row_path(100, 130) == ak.row_path(512, 130) == ak.row_path(100, 1024) == ak.ATTN_LOADS
    # the main shape: 4 batch groups of 2 sub-tiles beside 32 unit groups on
    # a 132-SM card, with the weights resident and 14160 bytes left to the
    # attention's stage beyond the ring
    smem = ak.seq_fwd_smem(2, 50, 512, 1024, 512, True, ak.SEQ_RING_BYTES)
    assert ak.CARD_SMEM - smem == 14160
