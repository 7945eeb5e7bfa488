"""LSTM forward and backward, and the LSTM scans.

Forward: the port's plain version (ops/lstm_kernels.lstm_fwd_plain)
against the JAX package's Pallas kernel `_lstm_pallas_raw` run in
interpret mode (on flipped operands for a reversed LSTM, as lstm_fused
does): h_seq, c_seq, h_T and c_T.

Tolerances: f32 1e-5 (the same f32 arithmetic summed in another order;
measured at most 2.4e-7). bf16: h and c are rounded to bf16 at the same
places on both sides, but a different f32 summation order can move a
rounding by one bf16 ulp, which then travels through the recurrence: at
most 8e-3 apart (one ulp of a c between 1 and 2) and at most 1% of h_seq's
elements differing (measured: 9.8e-4 and 0.07%). An LSTM that rounds its
recurrent product to bf16 before the add, as the JAX and the port's scans
do, differs in 43-67% of h_seq and fails
(`test_bf16_bounds_reject_the_scans_rounding`).

Backward: `lstm_bwd_plain`, on the pre-activations `lstm_bwd_inputs`
recomputes, against `_lstm_bwd_pallas` in interpret mode, with dW inside
the kernel and, with the threshold lowered on both sides, outside it; and
the autograd Function `lstm_fused` against jax.vjp of the JAX package's.
f32: dx and dW within 1e-6 of their largest element (measured 2.3e-7).
bf16: within 1e-2 of the largest element and at most 1% of dx's elements
differing (measured: dW 2.1e-3, dx differing in 0.007%). The same
backward with the dh and dc carries and the dgates kept in f32, rounded
only at the output, is at most 5.5e-3 off but differs in 16.5% of dx and
fails (`test_bwd_bf16_bound_rejects_carries_in_f32`).

The bf16 backward kernel's partition (`_tc_partition`: unit groups of 16
by 32-row batch groups exchanging rounded dgates, W padded by
`lstm_kernels.pad_w_bwd`, the dh carry's product as the kernel's warps sum
it, dW as one product after the walk) against the Pallas kernel and
lstm_bwd_plain with the same bounds, at H = 100, 301 and 512, B = 40
(measured: f32 within 4.6e-7; bf16 within 2.2e-3, dx differing in at most
0.15%). With the dgates exchanged unrounded it differs in 6.0% and 8.8% of
dx and fails (`test_bwd_partition_bound_rejects_dgates_exchanged_unrounded`).

Scans: the port's lstm_scan (peepholes, reverse, other activations) and
stacked_lstm2_scan against the JAX scans, f32 within 1e-5, bf16 bit for
bit (both compute op by op in bf16; measured: identical)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels, rnn_ops
from paddle_tpu_torch.ops import lstm_kernels
from paddle_tpu_torch.ops import rnn_ops as prnn

T, H = 7, 128


def _inputs(B, seed, H=H):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, 4 * H).astype(np.float32)
    w = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    b = (0.1 * rng.randn(4 * H)).astype(np.float32)
    lens = rng.randint(1, T + 1, size=B)
    lens[0] = T
    mask = np.arange(T)[:, None] < lens[None, :]  # [T, B], left aligned
    return x, w, b, mask


def _flip(a, reverse):
    return a[::-1] if reverse else a


def _pallas_fwd(xb, w, mask, reverse):
    """_lstm_pallas_raw on jnp inputs (bias added), flipped in and out for
    reverse; h_seq, c_seq, h_T, c_T as f32 numpy."""
    out = pallas_kernels._lstm_pallas_raw(_flip(xb, reverse), jnp.asarray(_flip(mask, reverse)),
                                          w.astype(xb.dtype))
    h_seq, c_seq = (_flip(o, reverse) for o in out[:2])
    return [np.asarray(o, np.float32) for o in (h_seq, c_seq, *out[2:])]


def _port_x(x, b, tdt):
    return torch.tensor(x).to(tdt) + torch.tensor(b).to(tdt)


_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
_BF16_MAX_DIFFERING = 0.01  # share of h_seq elements


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_matches_pallas_interpret(reverse, dtype):
    x, w, b, mask = _inputs(8, seed=1 + reverse)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    want = _pallas_fwd(jnp.asarray(x).astype(jdt) + jnp.asarray(b).astype(jdt),
                       jnp.asarray(w), mask, reverse)
    got = lstm_kernels.lstm_fwd_plain(_port_x(x, b, tdt), torch.tensor(mask),
                                      torch.tensor(w), reverse=reverse)
    assert [t.dtype for t in got] == [tdt] * 4 and got[0].shape == (T, 8, H)
    for name, a, t in zip(("h_seq", "c_seq", "h_T", "c_T"), want, got):
        np.testing.assert_allclose(t.float().numpy(), a, rtol=0, atol=_TOL[dtype], err_msg=name)
    if dtype == "bfloat16":
        assert np.mean(got[0].float().numpy() != want[0]) <= _BF16_MAX_DIFFERING


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bf16_bounds_reject_the_scans_rounding(reverse):
    """The bf16 LSTM that rounds h@W before adding x (the scans' rounding)
    breaks the kernel path's share bound."""
    x, w, b, mask = _inputs(8, seed=1 + reverse)
    bf = jnp.bfloat16
    want = _pallas_fwd(jnp.asarray(x).astype(bf) + jnp.asarray(b).astype(bf),
                       jnp.asarray(w), mask, reverse)
    h_seq, _ = prnn.lstm_scan(_port_x(x, b, torch.bfloat16), torch.tensor(mask),
                              torch.tensor(w), None, reverse=reverse)
    assert np.mean(h_seq.float().numpy() != want[0]) > _BF16_MAX_DIFFERING


def test_cpu_wrapper_runs_plain_and_launches_nothing():
    x, w, b, mask = _inputs(8, seed=3)
    args = (torch.tensor(x + b), torch.tensor(mask), torch.tensor(w))
    before = (lstm_kernels.lstm_fwd_launches, lstm_kernels.lstm_bwd_launches)
    got = lstm_kernels.lstm_fwd(*args, reverse=True)
    want = lstm_kernels.lstm_fwd_plain(*args, reverse=True)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    gp, cp, hp = lstm_kernels.lstm_bwd_inputs(args[0], args[2], got[0], got[1], True)
    bargs = (gp, cp, hp, torch.ones_like(hp), args[1], args[2], torch.zeros(8, H),
             torch.zeros(8, H))
    got = lstm_kernels.lstm_bwd(*bargs, reverse=True)
    want = lstm_kernels.lstm_bwd_plain(*bargs, reverse=True)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    assert (lstm_kernels.lstm_fwd_launches, lstm_kernels.lstm_bwd_launches) == before


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "mask_shape", "x_width"])
def test_fwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, mask = torch.zeros(T, 8, 4 * H), torch.zeros(H, 4 * H), torch.ones(T, 8)
    if bad == "dtype":
        x = x.half()
    elif bad == "w_shape":
        w = torch.zeros(H, 3 * H)
    elif bad == "mask_shape":
        mask = torch.ones(8, T)
    else:
        x = torch.zeros(T, 8, 4 * H + 2)
    with pytest.raises((TypeError, ValueError)):
        lstm_kernels.lstm_fwd(x, mask, w)


@pytest.mark.parametrize("bad", ["mixed_dtype", "gates_shape", "dcT_shape", "device"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    B = 8
    gp, cp, hp, dh = (torch.zeros(T, B, k) for k in (4 * H, H, H, H))
    w, mask, dhT, dcT = torch.zeros(H, 4 * H), torch.ones(T, B), torch.zeros(B, H), torch.zeros(B, H)
    if bad == "mixed_dtype":
        w = w.bfloat16()
    elif bad == "gates_shape":
        gp = torch.zeros(T, B, 3 * H)
    elif bad == "dcT_shape":
        dcT = torch.zeros(B, 2 * H)
    else:
        dcT = torch.zeros(B, H, device="meta")
    with pytest.raises((TypeError, ValueError)):
        lstm_kernels.lstm_bwd(gp, cp, hp, dh, mask, w, dhT, dcT)


# ------------------------------------------- the bf16 forward's W layout --
@pytest.mark.parametrize("H", [1, 16, 17, 100, 512])
def test_packed_columns_hold_every_gate_column_once(H):
    """pack_w's column order: each column of W [H, 4H] once, padding units
    as -1, and in each warp quad's 16 columns lane r's accumulator pairs
    (columns 2r, 2r+1 of the first n-tile, of the second) holding i, f and
    g, o of one unit."""
    cols = lstm_kernels.packed_columns(H)
    Hp = lstm_kernels.padded_units(H)
    assert Hp % 16 == 0 and H <= Hp < H + 16 and cols.numel() == 4 * Hp
    valid = cols[cols >= 0]
    assert sorted(valid.tolist()) == list(range(4 * H))
    assert int((cols < 0).sum()) == 4 * (Hp - H)
    quads = cols.reshape(Hp // 16, 4, 16)
    for grp in range(Hp // 16):
        for uq in range(4):
            for r in range(4):
                unit = grp * 16 + uq * 4 + r
                got = [int(quads[grp, uq, n]) for n in (2 * r, 2 * r + 1, 8 + 2 * r, 9 + 2 * r)]
                want = [g * H + unit if unit < H else -1 for g in range(4)]
                assert got == want


@pytest.mark.parametrize("H", [5, 100, 128])
def test_packed_product_unpacks_to_h_times_w(H):
    """h (padded to Hp) times the packed W, unpacked, is h @ W: the same
    dot products over the same terms, the padding adding zeros (float64)."""
    rng = np.random.RandomState(H)
    w = torch.as_tensor(rng.randn(H, 4 * H))
    h = torch.as_tensor(rng.randn(6, H))
    packed = lstm_kernels.pack_w(w)
    Hp = lstm_kernels.padded_units(H)
    assert packed.shape == (Hp // 16, 64, Hp) and packed.dtype == w.dtype
    hp = torch.zeros(6, Hp, dtype=h.dtype)
    hp[:, :H] = h
    got = lstm_kernels.unpack_gates(hp @ packed.reshape(-1, Hp).T, H)
    torch.testing.assert_close(got, h @ w, rtol=0, atol=1e-12)


def _packed_recurrence(x, mask, w, reverse):
    """lstm_fwd_plain's recurrence with its product taken through the bf16
    kernel's layout: h padded, times pack_w(W), unpacked."""
    T, B, H4 = x.shape
    H, dt = H4 // 4, x.dtype
    Hp = lstm_kernels.padded_units(H)
    wp = lstm_kernels.pack_w(w.to(dt)).float().reshape(-1, Hp)
    mf = mask.float()
    h = torch.zeros(B, H, dtype=dt)
    c = torch.zeros(B, H, dtype=dt)
    h_seq = torch.empty(T, B, H, dtype=dt)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hf, cf = h.float(), c.float()
        hpad = torch.zeros(B, Hp)
        hpad[:, :H] = hf
        i, f, g, o = lstm_kernels._gates(x[t].float() + lstm_kernels.unpack_gates(hpad @ wp.T, H))
        cn = f * cf + i * g
        m = mf[t][:, None]
        h = (m * o * torch.tanh(cn) + (1 - m) * hf).to(dt)
        c = (m * cn + (1 - m) * cf).to(dt)
        h_seq[t] = h
    return h_seq, h, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("shape", [(T, 8, H), (1, 3, 100), (4, 3, 100)], ids=["main", "T1", "H100"])
def test_packed_layout_matches_plain_and_pallas(shape, reverse, dtype):
    """The recurrence through the packed W against lstm_fwd_plain and the
    JAX package's kernel in interpret mode, with the forward's tolerances,
    at H a multiple of 16 and not, T=1, and a row masked at every step."""
    T_, B_, H_ = shape
    rng = np.random.RandomState(7 + H_)
    x = rng.randn(T_, B_, 4 * H_).astype(np.float32)
    w = (rng.randn(H_, 4 * H_) / np.sqrt(H_)).astype(np.float32)
    lens = rng.randint(1, T_ + 1, size=B_)
    lens[0], lens[1] = T_, 0
    mask = np.arange(T_)[:, None] < lens[None, :]
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    xt = torch.tensor(x).to(tdt)
    got = _packed_recurrence(xt, torch.tensor(mask), torch.tensor(w), reverse)
    plain = lstm_kernels.lstm_fwd_plain(xt, torch.tensor(mask), torch.tensor(w), reverse=reverse)
    want = _pallas_fwd(jnp.asarray(x).astype(jdt), jnp.asarray(w), mask, reverse)
    for name, g, p_, jw in zip(("h_seq", "h_T", "c_T"), got, (plain[0], plain[2], plain[3]),
                               (want[0], want[2], want[3])):
        for ref in (p_.float().numpy(), jw):
            np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=_TOL[dtype],
                                       err_msg=name)
    if dtype == "bfloat16":
        assert np.mean(got[0].float().numpy() != want[0]) <= _BF16_MAX_DIFFERING
    assert not got[0][:, 1].float().abs().any()  # the masked row keeps its zero state


# ------------------------------------------------------------- backward --
_BWD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
_BWD_BF16_MAX_DIFFERING = 0.01  # share of dx's elements


def _bwd_inputs(seed, reverse, dtype, B=8, H=H):
    """One seeded case: the backward's inputs in the io dtype, and the
    Pallas kernel's (dx, dW) on them as f32 numpy."""
    x, w, b, mask = _inputs(B, seed, H=H)
    rng = np.random.RandomState(seed + 100)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    xt, wt, mt = _port_x(x, b, tdt), torch.tensor(w).to(tdt), torch.tensor(mask)
    dh, dhT, dcT = (torch.tensor(0.1 * rng.randn(*s), dtype=torch.float32).to(tdt)
                    for s in ((T, B, H), (B, H), (B, H)))
    h_seq, c_seq, _, _ = lstm_kernels.lstm_fwd_plain(xt, mt, wt, reverse)
    gp, cp, hp = lstm_kernels.lstm_bwd_inputs(xt, wt, h_seq, c_seq, reverse)
    args = (gp, cp, hp, dh, mt, wt, dhT, dcT)
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)  # noqa: E731
    jx, jh, jc, jdh = (_flip(to_j(t), reverse) for t in (xt, h_seq, c_seq, dh))
    j_dx, j_dw = pallas_kernels._lstm_bwd_pallas(jx, jnp.asarray(_flip(mask, reverse)),
                                                 to_j(wt), jh, jc, jdh, to_j(dhT), to_j(dcT))
    return args, [np.asarray(a, np.float32) for a in (_flip(j_dx, reverse), j_dw)]


def _bwd_case(seed, reverse, dtype, carries_f32=False, B=8):
    """(Pallas dx, dW), (port dx, dW) as f32 numpy, on one seeded case."""
    tdt = getattr(torch, dtype)
    args, want = _bwd_inputs(seed, reverse, dtype, B)
    if carries_f32:
        got = lstm_kernels.lstm_bwd_plain(*(a.float() if a.is_floating_point() else a
                                            for a in args), reverse=reverse)
    else:
        got = lstm_kernels.lstm_bwd_plain(*args, reverse=reverse)
        assert got[0].dtype == tdt and got[1].shape == (H, 4 * H) and got[1].dtype == tdt
    return want, [t.to(tdt).float().numpy() for t in got]


def _assert_bwd_close(want, got, dtype):
    for name, a, b in zip(("dx", "dW"), want, got):
        assert np.abs(a - b).max() <= _BWD_TOL[dtype] * np.abs(a).max(), name
    if dtype == "bfloat16":
        assert np.mean(want[0] != got[0]) <= _BWD_BF16_MAX_DIFFERING


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bwd_plain_matches_pallas_interpret(reverse, dtype):
    want, got = _bwd_case(3 + reverse, reverse, dtype)
    _assert_bwd_close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_outer_dw_path_matches_pallas_interpret(monkeypatch, dtype):
    """Past the fused-dW threshold dW is one batched product outside the
    kernel, on both sides (the threshold lowered below H on both)."""
    monkeypatch.setattr(pallas_kernels, "_LSTM_FUSED_DW_MAX_H", H // 2)
    monkeypatch.setattr(lstm_kernels, "LSTM_FUSED_DW_MAX_H", H // 2)
    want, got = _bwd_case(5, False, dtype)
    _assert_bwd_close(want, got, dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bwd_bf16_bound_rejects_carries_in_f32(reverse):
    want, got = _bwd_case(3 + reverse, reverse, "bfloat16", carries_f32=True)
    assert np.mean(want[0] != got[0]) > _BWD_BF16_MAX_DIFFERING


# ------------------------------------------- the bf16 backward's partition --
def _tc_partition(gates_pre, c_prev, h_prev, dh_seq, mask, w, dhT, dcT, reverse=False,
                  exchange_rounded=True):
    """lstm_bwd_plain's function as csrc/lstm_bwd.cu's lstm_bwd_tc_kernel
    partitions it: CTAs of UNITS_PER_CTA units by ROWS_PER_TILE batch rows.
    Each does its pairs' gate math and publishes its rounded dgates into
    the exchange [B, 4·Hp] (gate q's columns at q·Hp, the padding zero);
    after the step's barrier each takes its units' dh carry from its rows
    of the exchange times its rows of pad_w_bwd(W): per gate (the k quarter
    of one warp) the k16 products added in k order, the four quarters in
    order, then (1-m)·dh, rounded once. dW after the walk, one product over
    all T·B rows of h_prev and dx, rounded once (for H <= 640; outside the
    kernel above, as lstm_bwd_plain). With `exchange_rounded` False the
    dgates are published unrounded. Returns (dx, dW)."""
    T_, B, H_ = h_prev.shape
    dt = h_prev.dtype
    U, R = lstm_kernels.UNITS_PER_CTA, lstm_kernels.ROWS_PER_TILE
    Hp = lstm_kernels.padded_units(H_)
    wp = lstm_kernels.pad_w_bwd(w.to(dt)).float()
    mf = mask.float()

    def units(t):  # [B, H] → [B, Hp] f32, the padding units 0
        return torch.cat([t.float(), torch.zeros(B, Hp - H_)], 1)

    dh_c, dc_c = units(dhT.to(dt)), units(dcT.to(dt))
    dx = torch.empty(T_, B, 4 * H_, dtype=dt)
    ctas = [(slice(u, u + U), slice(r, min(B, r + R))) for u in range(0, Hp, U)
            for r in range(0, B, R)]
    for t in (range(T_) if reverse else range(T_ - 1, -1, -1)):
        ex = torch.zeros(B, 4 * Hp)
        part = torch.zeros(B, Hp)
        gp = gates_pre[t].float().reshape(B, 4, H_)
        for js, bs in ctas:  # the gate math, from local values
            js = slice(js.start, min(H_, js.stop))
            if js.start >= js.stop:
                continue
            i, f = torch.sigmoid(gp[bs, 0, js]), torch.sigmoid(gp[bs, 1, js])
            g, o = torch.tanh(gp[bs, 2, js]), torch.sigmoid(gp[bs, 3, js])
            cp, m = c_prev[t, bs, js].float(), mf[t, bs][:, None]
            tc = torch.tanh(f * cp + i * g)
            dh = dh_seq[t, bs, js].float() + dh_c[bs, js]
            dc = dc_c[bs, js]
            dh_raw = m * dh
            dc_raw = m * dc + dh_raw * o * (1 - tc * tc)
            d = torch.stack([dc_raw * g * i * (1 - i), dc_raw * cp * f * (1 - f),
                             dc_raw * i * (1 - g * g), dh_raw * tc * o * (1 - o)], 1)
            dq = d.to(dt)
            for q in range(4):
                dx[t, bs, q * H_ + js.start:q * H_ + js.stop] = dq[:, q]
                ex[bs, q * Hp + js.start:q * Hp + js.stop] = \
                    dq[:, q].float() if exchange_rounded else d[:, q]
            dc_c[bs, js] = (dc_raw * f + (1 - m) * dc).to(dt).float()
            part[bs, js] = (1 - m) * dh
        for js, bs in ctas:  # after the barrier: the dh carry
            quarters = []
            for kq in range(4):
                acc = torch.zeros(bs.stop - bs.start, U)
                for k in range(kq * Hp, (kq + 1) * Hp, 16):
                    acc = acc + ex[bs, k:k + 16] @ wp[js, k:k + 16].T
                quarters.append(acc)
            total = ((quarters[0] + quarters[1]) + quarters[2]) + quarters[3]
            dh_c[bs, js] = (total + part[bs, js]).to(dt).float()
    if H_ > lstm_kernels.LSTM_FUSED_DW_MAX_H:
        return dx, lstm_kernels._dw_outside(h_prev, dx)
    rows = T_ * B
    dw = h_prev.reshape(rows, H_).float().T @ dx.reshape(rows, 4 * H_).float()
    return dx, dw.to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hs", [100, 301, 512])
def test_bwd_partition_matches_plain_and_pallas(Hs, dtype):
    """The bf16 backward kernel's partition (unit groups of 16, 32-row
    batch groups exchanging rounded dgates, W padded to whole groups, dW
    after the walk) against lstm_bwd_plain and the JAX package's kernel in
    interpret mode, with the backward's bounds, at H a multiple of 16 and
    not; B=40 walks two batch tiles, the second partial."""
    args, want = _bwd_inputs(50 + Hs, False, dtype, B=40, H=Hs)
    got = [t.float().numpy() for t in _tc_partition(*args)]
    plain = [t.float().numpy() for t in lstm_kernels.lstm_bwd_plain(*args)]
    _assert_bwd_close(want, got, dtype)
    _assert_bwd_close(plain, got, dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bwd_partition_bound_rejects_dgates_exchanged_unrounded(reverse):
    """In bf16 the partition with the dgates exchanged unrounded (the dh
    carry's product on f32 dgates) breaks the share bound."""
    args, want = _bwd_inputs(3 + reverse, reverse, "bfloat16")
    got = [t.float().numpy() for t in _tc_partition(*args, reverse=reverse,
                                                    exchange_rounded=False)]
    assert np.mean(want[0] != got[0]) > _BWD_BF16_MAX_DIFFERING


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstm_fused_autograd_matches_jax_vjp(reverse):
    """The autograd Function over the kernels' plain versions against
    jax.vjp of the JAX package's lstm_fused (Pallas in interpret mode):
    the outputs, and the gradients of x, W and the bias for cotangents on
    h_seq, h_T and c_T, f32."""
    x, w, b, mask = _inputs(8, seed=20 + reverse)
    rng = np.random.RandomState(1)
    cots = [rng.randn(*s).astype(np.float32) for s in ((T, 8, H), (8, H), (8, H))]

    def jfn(x, w, b):
        h_seq, (h_T, c_T) = pallas_kernels.lstm_fused(x, jnp.asarray(mask), w, bias=b,
                                                      reverse=reverse)
        return h_seq, h_T, c_T

    outs, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    h_seq, (h_T, c_T) = lstm_kernels.lstm_fused(xt, torch.tensor(mask), wt, bt, reverse=reverse)
    for a, t in zip(outs, (h_seq, h_T, c_T)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0, atol=1e-5)
    sum((t * torch.tensor(c)).sum() for t, c in zip((h_seq, h_T, c_T), cots)).backward()
    for name, a, t in zip(("x", "W", "bias"), want, (xt, wt, bt)):
        a = np.asarray(a)
        np.testing.assert_allclose(t.grad.numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)


# ----------------------------------------------------------------- scans --
_SCAN_CASES = {
    "plain": {},
    "reverse": dict(reverse=True),
    "peepholes": dict(peep=True),
    "activations": dict(gate_act="sigmoid", cell_act="relu", cand_act="identity"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_lstm_scan_matches_jax(case, dtype):
    kw = dict(_SCAN_CASES[case])
    x, w, b, mask = _inputs(8, seed=30, H=32)
    peep = (0.1 * np.random.RandomState(31).randn(3 * 32)).astype(np.float32) \
        if kw.pop("peep", False) else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    j_seq, (j_h, j_c) = rnn_ops.lstm_scan(
        jnp.asarray(x).astype(jdt), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(b),
        w_peephole=None if peep is None else jnp.asarray(peep), **kw)
    p_seq, (p_h, p_c) = prnn.lstm_scan(
        torch.tensor(x).to(tdt), torch.tensor(mask), torch.tensor(w), torch.tensor(b),
        w_peephole=None if peep is None else torch.tensor(peep), **kw)
    for a, t in ((j_seq, p_seq), (j_h, p_h), (j_c, p_c)):
        assert t.dtype == tdt
        a, t = np.asarray(a, np.float32), t.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t, a)
        else:
            np.testing.assert_allclose(t, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_lstm2_scan_matches_jax(dtype):
    x, w1, b1, mask = _inputs(8, seed=40, H=32)
    rng = np.random.RandomState(41)
    wx2, w2 = ((rng.randn(32, 128) / np.sqrt(32)).astype(np.float32) for _ in range(2))
    b2 = (0.1 * rng.randn(128)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    j_seq, (j_h, j_c) = rnn_ops.stacked_lstm2_scan(
        jnp.asarray(x).astype(jdt), jnp.asarray(mask),
        *(jnp.asarray(a) for a in (w1, b1, wx2, w2, b2)))
    p_seq, (p_h, p_c) = prnn.stacked_lstm2_scan(
        torch.tensor(x).to(tdt), torch.tensor(mask),
        *(torch.tensor(a) for a in (w1, b1, wx2, w2, b2)))
    for a, t in ((j_seq, p_seq), (j_h, p_h), (j_c, p_c)):
        a, t = np.asarray(a, np.float32), t.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t, a)
        else:
            np.testing.assert_allclose(t, a, rtol=0, atol=1e-5)
