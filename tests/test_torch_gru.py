"""GRU forward and backward.

Forward: the port's plain version (ops/rnn_kernels.gru_fwd_plain)
against the JAX package's Pallas kernel `_gru_pallas_raw` run in interpret
mode (through `gru_fused`, which adds the bias and flips for reverse) and
against its `rnn_ops.gru_scan`.

Tolerances: f32 1e-5 (the same f32 arithmetic, summed in another order).
bf16: at most 1e-3 apart and at most 1% of h_seq's elements differing.
rh and the carried h are rounded to bf16 at the same places on both sides;
a different f32 summation order can still move a rounding by one bf16 ulp
(2^-8 relative). On these inputs the sound plain version reads at most
6.1e-5, with 0.007% of elements differing. The same recurrence rounded
to bf16 only at its output (rh and the carried h kept in f32) reads
3.9e-3, one ulp near |h| = 1, with 10-24% of elements differing, and
`test_bf16_bounds_reject_rounding_elsewhere` holds the bounds to that.

Backward: `gru_bwd_plain`, on the pre-activations `gru_bwd_inputs`
recomputes, against the Pallas kernel `_gru_bwd_pallas` in interpret mode
(called on flipped operands for a reversed GRU, as gru_fused does), and
the autograd Function `gru_fused` against jax.grad of the JAX package's.
f32: dx and dW within 1e-6 of their largest element (measured 1.9e-7).
bf16: within 1e-2 of the largest element and at most 1% of dx's elements
differing (measured: identical). The same backward with the dh carry and
dc_pre kept in f32, rounded to bf16 only at the output, is at most
3.6e-3 off but differs in 20% of dx and fails
(`test_bwd_bf16_bound_rejects_a_dh_carry_in_f32`).

The bf16 kernels' partitions (`_fwd_partition`, `_bwd_partition`: unit
groups of 16 by 32-row batch groups, the forward exchanging h and io(r·h)
through W in `rnn_kernels.pack_w`'s layout, the backward exchanging
rounded [du | dc] and then dr through W padded by `pad_w_bwd`, each
product's k16 fragments added in f32 in k order, dW after the walk)
against the plain versions and the Pallas kernels in interpret mode at H
of 100, 301 and 128, B=40 (a partial second tile) with a row masked at
every step, with the bounds chip_smoke.py holds the kernels to (bf16:
4e-3 and 5% of h_seq; 1e-2 of the largest element and 5% of dx). Measured
against the Pallas kernels: f32 within 3.1e-7 (forward) and 4.8e-7 of the
largest element (backward); bf16 within 4.9e-4 with 0.013% of h_seq
differing, and within 1.3e-3 with 0.073% of dx differing. With rh
exchanged unrounded the forward differs in 12.3% and 6.5% of h_seq, and
with [du | dr] exchanged unrounded the backward in 6.8% and 7.7% of dx:
both fail the share bound (`test_*_partition_bound_rejects_*`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels, rnn_ops
from paddle_tpu_torch.ops import rnn_kernels

T, H = 7, 128


def _pallas_bf16(x, w, b, mask, reverse):
    j_seq, j_T = pallas_kernels.gru_fused(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask), jnp.asarray(w),
        bias=jnp.asarray(b), reverse=reverse)
    return np.asarray(j_seq, np.float32), np.asarray(j_T, np.float32)


def _inputs(B, seed, H=H, masked_row=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, 3 * H).astype(np.float32)
    w = (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    b = (0.1 * rng.randn(3 * H)).astype(np.float32)
    lens = rng.randint(1, T + 1, size=B)
    lens[0] = T
    if masked_row:
        lens[1] = 0  # a row masked at every step
    mask = (np.arange(T)[:, None] < lens[None, :])  # [T, B], left aligned
    return x, w, b, mask


_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
_BF16_MAX_DIFFERING = 0.01  # share of h_seq elements


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("B", [8, 16])
def test_plain_matches_pallas_interpret(B, reverse, dtype):
    x, w, b, mask = _inputs(B, seed=B + 2 * reverse)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    j_seq, j_T = pallas_kernels.gru_fused(
        jnp.asarray(x).astype(jdt), jnp.asarray(mask), jnp.asarray(w),
        bias=jnp.asarray(b), reverse=reverse)
    xt = torch.tensor(x).to(tdt) + torch.tensor(b).to(tdt)
    p_seq, p_T = rnn_kernels.gru_fwd_plain(xt, torch.tensor(mask), torch.tensor(w),
                                           reverse=reverse)
    assert p_seq.dtype == tdt and p_seq.shape == (T, B, H)
    tol = _TOL[dtype]
    np.testing.assert_allclose(p_seq.float().numpy(), np.asarray(j_seq, np.float32),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(p_T.float().numpy(), np.asarray(j_T, np.float32),
                               rtol=0, atol=tol)
    if dtype == "bfloat16":
        differing = float(np.mean(p_seq.float().numpy() != np.asarray(j_seq, np.float32)))
        assert differing <= _BF16_MAX_DIFFERING, differing


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("B", [8, 16])
def test_bf16_bounds_reject_rounding_elsewhere(B, reverse):
    """The plain recurrence run in f32 and rounded to bf16 only at its
    output breaks both bf16 bounds against the Pallas kernel."""
    x, w, b, mask = _inputs(B, seed=B + 2 * reverse)
    j_seq, _ = _pallas_bf16(x, w, b, mask, reverse)
    xt = (torch.tensor(x).bfloat16() + torch.tensor(b).bfloat16()).float()
    f_seq, _ = rnn_kernels.gru_fwd_plain(xt, torch.tensor(mask),
                                         torch.tensor(w).bfloat16().float(), reverse=reverse)
    f_seq = f_seq.bfloat16().float().numpy()
    assert np.abs(f_seq - j_seq).max() > _TOL["bfloat16"]
    assert np.mean(f_seq != j_seq) > _BF16_MAX_DIFFERING


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("B", [8, 16])
def test_plain_matches_jax_scan_f32(B, reverse):
    x, w, b, mask = _inputs(B, seed=10 + B + reverse)
    j_seq, j_T = rnn_ops.gru_scan(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
                                  jnp.asarray(b), reverse=reverse)
    p_seq, p_T = rnn_kernels.gru_fwd_plain(torch.tensor(x + b), torch.tensor(mask),
                                           torch.tensor(w), reverse=reverse)
    np.testing.assert_allclose(p_seq.numpy(), np.asarray(j_seq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p_T.numpy(), np.asarray(j_T), rtol=0, atol=1e-5)
    # padding steps hold h: past a sequence's end (fwd) or before its
    # start (rev, where the flipped padding comes first and h stays 0)
    short = int(np.argmin(mask.sum(0)))
    n = int(mask[:, short].sum())
    if n < T:
        if reverse:
            assert torch.all(p_seq[n:, short] == 0)
        else:
            assert torch.all(p_seq[n:, short] == p_seq[n - 1, short])


def test_cpu_wrapper_runs_plain_and_launches_nothing():
    x, w, b, mask = _inputs(8, seed=3)
    before = rnn_kernels.gru_fwd_launches
    args = (torch.tensor(x + b), torch.tensor(mask), torch.tensor(w))
    got = rnn_kernels.gru_fwd(*args, reverse=True)
    want = rnn_kernels.gru_fwd_plain(*args, reverse=True)
    assert rnn_kernels.gru_fwd_launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "mask_shape", "x_rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(T, 8, 3 * H)
    w = torch.zeros(H, 3 * H)
    mask = torch.ones(T, 8)
    if bad == "dtype":
        x = x.half()
    elif bad == "w_shape":
        w = torch.zeros(H, 2 * H)
    elif bad == "mask_shape":
        mask = torch.ones(8, T)
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        rnn_kernels.gru_fwd(x, mask, w)


# ------------------------------------------------------------- backward --
_BWD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
_BWD_BF16_MAX_DIFFERING = 0.01  # share of dx's elements


def _bwd_args(B, seed, reverse, dtype, H=H, masked_row=False):
    """The backward's inputs on one seeded case (the pre-activations
    gru_bwd_inputs recomputes from the plain forward's h_seq), and the
    Pallas kernel's (dx, dW) on them as f32 numpy."""
    x, w, b, mask = _inputs(B, seed, H, masked_row)
    T_ = x.shape[0]
    rng = np.random.RandomState(seed + 100)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    xt = torch.tensor(x).to(tdt) + torch.tensor(b).to(tdt)
    wt, mt = torch.tensor(w).to(tdt), torch.tensor(mask)
    dh = torch.tensor(0.1 * rng.randn(T_, B, H), dtype=torch.float32).to(tdt)
    dhT = torch.tensor(0.1 * rng.randn(B, H), dtype=torch.float32).to(tdt)
    h_seq, _ = rnn_kernels.gru_fwd_plain(xt, mt, wt, reverse)
    h_prev, ur, c, rh = rnn_kernels.gru_bwd_inputs(xt, wt, h_seq, reverse)
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)  # noqa: E731
    jx, jm, jh, jdh = to_j(xt), jnp.asarray(mask), to_j(h_seq), to_j(dh)
    if reverse:  # gru_fused's flip in and out
        jx, jm, jh, jdh = jx[::-1], jm[::-1], jh[::-1], jdh[::-1]
    j_dx, j_dw = pallas_kernels._gru_bwd_pallas(jx, jm, to_j(wt), jh, jdh, to_j(dhT))
    if reverse:
        j_dx = j_dx[::-1]
    return (ur, c, h_prev, rh, dh, mt, wt, dhT), [np.asarray(a, np.float32) for a in (j_dx, j_dw)]


def _bwd_case(B, seed, reverse, dtype, carry_f32=False):
    """(Pallas dx, dW), (port dx, dW) as f32 numpy, on one seeded case."""
    tdt = getattr(torch, dtype)
    args, want = _bwd_args(B, seed, reverse, dtype)
    if carry_f32:
        got = rnn_kernels.gru_bwd_plain(*(a.float() if a.is_floating_point() else a
                                          for a in args), reverse=reverse)
    else:
        got = rnn_kernels.gru_bwd_plain(*args, reverse=reverse)
        assert got[0].dtype == tdt and got[1].shape == (H, 3 * H)
    return want, [t.to(tdt).float().numpy() for t in got]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bwd_plain_matches_pallas_interpret(reverse, dtype):
    want, got = _bwd_case(8, 3 + reverse, reverse, dtype)
    for name, a, b in zip(("dx", "dW"), want, got):
        assert np.abs(a - b).max() <= _BWD_TOL[dtype] * np.abs(a).max(), name
    if dtype == "bfloat16":
        assert np.mean(want[0] != got[0]) <= _BWD_BF16_MAX_DIFFERING


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bwd_bf16_bound_rejects_a_dh_carry_in_f32(reverse):
    want, got = _bwd_case(8, 3 + reverse, reverse, "bfloat16", carry_f32=True)
    assert np.mean(want[0] != got[0]) > _BWD_BF16_MAX_DIFFERING


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_fused_autograd_matches_jax_grad(reverse):
    """The autograd Function over the kernels' plain versions against
    jax.grad of the JAX package's gru_fused (Pallas in interpret mode):
    gradients of x, W and the bias, f32."""
    import jax

    x, w, b, mask = _inputs(8, seed=20 + reverse)
    rng = np.random.RandomState(1)
    r_seq, r_T = rng.randn(T, 8, H).astype(np.float32), rng.randn(8, H).astype(np.float32)

    def jloss(x, w, b):
        h_seq, h_T = pallas_kernels.gru_fused(x, jnp.asarray(mask), w, bias=b, reverse=reverse)
        return jnp.sum(h_seq * r_seq) + jnp.sum(h_T * r_T)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    h_seq, h_T = rnn_kernels.gru_fused(xt, torch.tensor(mask), wt, bt, reverse=reverse)
    ((h_seq * torch.tensor(r_seq)).sum() + (h_T * torch.tensor(r_T)).sum()).backward()
    for name, a, t in zip(("x", "W", "bias"), want, (xt, wt, bt)):
        a = np.asarray(a)
        np.testing.assert_allclose(t.grad.numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)


def test_cpu_bwd_wrapper_runs_plain_and_launches_nothing():
    x, w, b, mask = _inputs(8, seed=3)
    xt, wt, mt = torch.tensor(x + b), torch.tensor(w), torch.tensor(mask)
    h_seq, _ = rnn_kernels.gru_fwd_plain(xt, mt, wt)
    h_prev, ur, c, rh = rnn_kernels.gru_bwd_inputs(xt, wt, h_seq)
    args = (ur, c, h_prev, rh, torch.ones_like(h_seq), mt, wt, torch.zeros(8, H))
    before = rnn_kernels.gru_bwd_launches
    got = rnn_kernels.gru_bwd(*args)
    want = rnn_kernels.gru_bwd_plain(*args)
    assert rnn_kernels.gru_bwd_launches == before
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "w_shape", "mask_shape", "dhT_shape"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    B = 8
    ur, c, h_prev, rh, dh = (torch.zeros(T, B, k) for k in (2 * H, H, H, H, H))
    w, mask, dhT = torch.zeros(H, 3 * H), torch.ones(T, B), torch.zeros(B, H)
    if bad == "dtype":
        ur, c, h_prev, rh, dh, w, dhT = (t.half() for t in (ur, c, h_prev, rh, dh, w, dhT))
    elif bad == "mixed_dtype":
        w = w.bfloat16()
    elif bad == "w_shape":
        w = torch.zeros(H, 2 * H)
    elif bad == "mask_shape":
        mask = torch.ones(B, T)
    else:
        dhT = torch.zeros(B, 2 * H)
    with pytest.raises((TypeError, ValueError)):
        rnn_kernels.gru_bwd(ur, c, h_prev, rh, dh, mask, w, dhT)


def test_kernel_library_name_tracks_the_source_and_the_shared_headers(tmp_path, monkeypatch):
    """A kernel is rebuilt when its .cu or a shared csrc/*.cuh changes, and
    only then (nothing is compiled here: lib_path only names the library)."""
    from paddle_tpu_torch.ops import cuda_build

    for name in ("k.cu", "other.cu", "common.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    first = cuda_build.lib_path("k")
    (tmp_path / "other.cu").write_text("// edited\n")
    assert cuda_build.lib_path("k") == first
    (tmp_path / "common.cuh").write_text("// edited\n")
    second = cuda_build.lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text("// edited\n")
    assert cuda_build.lib_path("k") not in (first, second)


# ---------------------------------------- the bf16 kernels' partitions --
# csrc/gru_fwd.cu's and csrc/gru_bwd.cu's bf16 kernels against the plain
# versions and the Pallas kernels, with the bounds chip_smoke.py holds the
# kernels to on the card: the forward within 4e-3 (one bf16 ulp just below
# 1) with at most 5% of h_seq differing, the backward within 1e-2 of each
# output's largest element with at most 5% of dx differing; f32 with this
# file's bounds.
_PART_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
_PART_BWD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
_PART_MAX_DIFFERING = 0.05


def _frag_sum(a, rows):
    """a [R, Hp] times rows [N, Hp]ᵀ as the kernels' warps sum it: each k16
    product a fragment of its own, the fragments added in f32 in k order."""
    R, Hp = a.shape
    parts = torch.einsum("rks,nks->krn", a.reshape(R, Hp // 16, 16),
                         rows.reshape(rows.shape[0], Hp // 16, 16))
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _pad(t, rows, cols):
    """t [B, H] f32 in a zeroed [rows, cols] exchange (padding rows and
    units zero, as the kernels' zeroed buffers keep them)."""
    out = torch.zeros(rows, cols)
    out[:t.shape[0], :t.shape[1]] = t.float()
    return out


def _fwd_partition(x, mask, w, reverse=False, rh_rounded=True):
    """gru_fwd_plain's function as gru_fwd_tc_kernel partitions it: CTAs
    of UNITS_PER_CTA units by ROWS_PER_TILE batch rows, W in pack_w's
    layout (u and r of a unit side by side, then c's 16 columns, H padded
    to Hp). Each step (a) takes every CTA's u, r from the h exchange (rows
    padded to whole 32-row tiles, units to Hp, the padding zero) through
    the packed W, and publishes io(r·h) into the rh exchange; (b) takes c
    from the rh exchange and the masked carry, rounded, published as the
    next h. A CTA's outputs depend on its rows of the exchange and its
    columns of W only, so the walk computes every CTA at once. With
    `rh_rounded` False, rh is exchanged unrounded. Returns (h_seq, h_T)."""
    T_, B, H3 = x.shape
    H_, dt = H3 // 3, x.dtype
    U, Bp = rnn_kernels.UNITS_PER_CTA, -(-B // rnn_kernels.ROWS_PER_TILE) * rnn_kernels.ROWS_PER_TILE
    Hp = rnn_kernels.padded_units(H_)
    wp = rnn_kernels.pack_w(w.to(dt)).float()  # [groups, 48, Hp]
    w_ur, w_c = wp[:, :2 * U].reshape(-1, Hp), wp[:, 2 * U:].reshape(-1, Hp)
    cols = rnn_kernels.packed_columns(H_).reshape(-1, 3 * U)[:, :2 * U].reshape(-1)
    valid = cols >= 0
    hx = torch.zeros(Bp, Hp)  # the h exchange
    h_seq = torch.empty(T_, B, H_, dtype=dt)
    for t in (range(T_ - 1, -1, -1) if reverse else range(T_)):
        xt = x[t].float()
        ur = torch.empty(B, 2 * H_)
        ur[:, cols[valid]] = _frag_sum(hx, w_ur)[:B, valid]
        u, r = torch.sigmoid(xt[:, :H_] + ur[:, :H_]), torch.sigmoid(xt[:, H_:2 * H_] + ur[:, H_:])
        h = hx[:B, :H_]
        rh = (r * h).to(dt).float() if rh_rounded else r * h
        c = torch.tanh(xt[:, 2 * H_:] + _frag_sum(_pad(rh, Bp, Hp), w_c)[:B, :H_])
        m = mask[t].float()[:, None]
        hv = (m * ((1 - u) * h + u * c) + (1 - m) * h).to(dt)
        h_seq[t] = hv
        hx = _pad(hv, Bp, Hp)
    return h_seq, hv


def _bwd_partition(ur_pre, c_pre, h_prev, rh, dh_seq, mask, w, dhT, reverse=False,
                   exchange_rounded=True):
    """gru_bwd_plain's function as gru_bwd_tc_kernel partitions it: CTAs
    of UNITS_PER_CTA units by ROWS_PER_TILE batch rows, W padded by
    pad_w_bwd ([Hp, 3·Hp], gate q's columns at q·Hp). Each step (A) the
    gate math, [du | dc] rounded into the exchange; (B) drh = dc · W_cᵀ,
    then dr rounded into the exchange, and the du part du · W_uᵀ; (C) the
    dr part dr · W_rᵀ and the carry ((((1-m)·dh + dh_raw·(1-u)) + drh·r) +
    du part) + dr part, rounded once; each product's k16 fragments added in
    k order. dW after the walk, [h_prevᵀ dx_ur | rhᵀ dx_c] over all T·B
    rows, rounded once (outside the kernel above GRU_FUSED_DW_MAX_H, as
    gru_bwd_plain). With `exchange_rounded` False, du and dr are exchanged
    unrounded. Returns (dx, dW)."""
    T_, B, H_ = h_prev.shape
    dt = h_prev.dtype
    Bp = -(-B // rnn_kernels.ROWS_PER_TILE) * rnn_kernels.ROWS_PER_TILE
    Hp = rnn_kernels.padded_units(H_)
    wp = rnn_kernels.pad_w_bwd(w.to(dt)).float()
    w_u, w_r, w_c = wp[:, :Hp], wp[:, Hp:2 * Hp], wp[:, 2 * Hp:]
    mf = mask.float()
    carry = dhT.to(dt).float()
    dx = torch.empty(T_, B, 3 * H_, dtype=dt)
    for t in (range(T_) if reverse else range(T_ - 1, -1, -1)):
        ur = torch.sigmoid(ur_pre[t].float())
        u, r = ur[:, :H_], ur[:, H_:]
        c, hp, m = torch.tanh(c_pre[t].float()), h_prev[t].float(), mf[t][:, None]
        dh = dh_seq[t].float() + carry
        dh_raw = m * dh
        dc, du = dh_raw * u * (1 - c * c), dh_raw * (c - hp) * u * (1 - u)
        dcq, duq = dc.to(dt), du.to(dt)
        run = (1 - m) * dh + dh_raw * (1 - u)
        drh = _frag_sum(_pad(dcq, Bp, Hp), w_c)[:B, :H_]  # (B)
        dr = drh * hp * r * (1 - r)
        drq = dr.to(dt)
        run = run + drh * r
        du_part = _frag_sum(_pad(duq if exchange_rounded else du, Bp, Hp), w_u)[:B, :H_]
        dr_part = _frag_sum(_pad(drq if exchange_rounded else dr, Bp, Hp), w_r)[:B, :H_]  # (C)
        carry = ((run + du_part) + dr_part).to(dt).float()
        dx[t] = torch.cat([duq, drq, dcq], dim=1)
    if H_ > rnn_kernels.GRU_FUSED_DW_MAX_H:
        return dx, rnn_kernels._dw_outside(h_prev, rh, dx)
    rows = T_ * B
    dw = torch.cat([h_prev.reshape(rows, H_).float().T @ dx[..., :2 * H_].reshape(rows, -1).float(),
                    rh.reshape(rows, H_).float().T @ dx[..., 2 * H_:].reshape(rows, -1).float()], 1)
    return dx, dw.to(dt)


def _assert_fwd_close(want, got, dtype):
    for a, b in zip(want, got):
        assert np.abs(a - b).max() <= _PART_TOL[dtype], np.abs(a - b).max()
    if dtype == "bfloat16":
        assert np.mean(want[0] != got[0]) <= _PART_MAX_DIFFERING


def _assert_bwd_close(want, got, dtype):
    for name, a, b in zip(("dx", "dW"), want, got):
        assert np.abs(a - b).max() <= _PART_BWD_TOL[dtype] * np.abs(a).max(), name
    if dtype == "bfloat16":
        assert np.mean(want[0] != got[0]) <= _PART_MAX_DIFFERING


def _fwd_args(B, seed, H, dtype, masked_row=True):
    """Seeded inputs (bias added, a row masked at every step) and the
    Pallas kernel's (h_seq, h_T) on them as f32 numpy."""
    x, w, b, mask = _inputs(B, seed, H, masked_row)
    j = pallas_kernels.gru_fused(jnp.asarray(x).astype(jnp.dtype(dtype)), jnp.asarray(mask),
                                 jnp.asarray(w), bias=jnp.asarray(b))
    tdt = getattr(torch, dtype)
    args = (torch.tensor(x).to(tdt) + torch.tensor(b).to(tdt), torch.tensor(mask),
            torch.tensor(w).to(tdt))
    return args, [np.asarray(a, np.float32) for a in j]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hs", [100, 301, 128])
def test_fwd_partition_matches_plain_and_pallas(Hs, dtype):
    """The bf16 forward kernel's partition (unit groups of 16, 32-row batch
    groups exchanging h and io(r·h), W packed and padded to Hp, k16
    fragments summed in k order) against gru_fwd_plain and the JAX
    package's kernel in interpret mode, at H a multiple of 16 and not;
    B=40 walks two batch tiles, the second partial, one row masked at
    every step."""
    args, want = _fwd_args(40, 60 + Hs, Hs, dtype)
    got = [t.float().numpy() for t in _fwd_partition(*args)]
    plain = [t.float().numpy() for t in rnn_kernels.gru_fwd_plain(*args)]
    _assert_fwd_close(want, got, dtype)
    _assert_fwd_close(plain, got, dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_fwd_partition_bound_rejects_rh_exchanged_unrounded(reverse):
    """In bf16 the partition with rh exchanged unrounded (the c product on
    f32 r·h) breaks the share bound against the Pallas kernel."""
    x, w, b, mask = _inputs(40, 70 + reverse)
    want, _ = _pallas_bf16(x, w, b, mask, reverse)
    args = (torch.tensor(x).bfloat16() + torch.tensor(b).bfloat16(), torch.tensor(mask),
            torch.tensor(w).bfloat16())
    got = _fwd_partition(*args, reverse=reverse, rh_rounded=False)[0].float().numpy()
    assert np.mean(want != got) > _PART_MAX_DIFFERING


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hs", [100, 301, 128])
def test_bwd_partition_matches_plain_and_pallas(Hs, dtype):
    """The bf16 backward kernel's partition (unit groups of 16, 32-row
    batch groups exchanging rounded [du | dc], then dr, W padded to whole
    groups, dW after the walk) against gru_bwd_plain and the JAX package's
    kernel in interpret mode, at H a multiple of 16 and not; B=40 walks
    two batch tiles, the second partial, one row masked at every step."""
    args, want = _bwd_args(40, 80 + Hs, False, dtype, H=Hs, masked_row=True)
    got = [t.float().numpy() for t in _bwd_partition(*args)]
    plain = [t.float().numpy() for t in rnn_kernels.gru_bwd_plain(*args)]
    _assert_bwd_close(want, got, dtype)
    _assert_bwd_close(plain, got, dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bwd_partition_bound_rejects_du_dr_exchanged_unrounded(reverse):
    """In bf16 the partition with [du | dr] exchanged unrounded (the
    carry's products on f32 gate gradients) breaks the share bound."""
    args, want = _bwd_args(40, 90 + reverse, reverse, "bfloat16")
    got = _bwd_partition(*args, reverse=reverse, exchange_rounded=False)[0].float().numpy()
    assert np.mean(want[0] != got) > _PART_MAX_DIFFERING


@pytest.mark.parametrize("Hs", [1, 16, 17, 100, 512])
def test_packed_columns_hold_every_gate_column_once(Hs):
    """pack_w's column order: each column of W [H, 3H] once, padding units
    as -1; in each warp quad's 8 u, r columns lane r's accumulator pair
    (columns 2r, 2r+1) holds u and r of one unit, and c's 16 columns hold
    the group's units in order."""
    cols = rnn_kernels.packed_columns(Hs)
    Hp = rnn_kernels.padded_units(Hs)
    assert Hp % 16 == 0 and Hs <= Hp < Hs + 16 and cols.numel() == 3 * Hp
    assert sorted(cols[cols >= 0].tolist()) == list(range(3 * Hs))
    assert int((cols < 0).sum()) == 3 * (Hp - Hs)
    groups = cols.reshape(Hp // 16, 48)
    for grp in range(Hp // 16):
        for uq in range(4):
            for r in range(4):
                unit = grp * 16 + uq * 4 + r
                got = [int(groups[grp, 8 * uq + 2 * r + gate]) for gate in (0, 1)]
                assert got == ([unit, Hs + unit] if unit < Hs else [-1, -1])
        c = [int(v) for v in groups[grp, 32:]]
        assert c == [2 * Hs + u if u < Hs else -1 for u in range(grp * 16, grp * 16 + 16)]


@pytest.mark.parametrize("Hs", [5, 100, 128])
def test_packed_product_unpacks_to_h_times_w(Hs):
    """h (padded to Hp) times the packed W, unpacked, is h @ W: the same
    dot products over the same terms, the padding adding zeros (float64);
    and pad_w_bwd's rows are W's, gate q's columns at q·Hp."""
    rng = np.random.RandomState(Hs)
    w = torch.as_tensor(rng.randn(Hs, 3 * Hs))
    h = torch.as_tensor(rng.randn(6, Hs))
    packed = rnn_kernels.pack_w(w)
    Hp = rnn_kernels.padded_units(Hs)
    assert packed.shape == (Hp // 16, 48, Hp) and packed.dtype == w.dtype
    hp = torch.zeros(6, Hp, dtype=h.dtype)
    hp[:, :Hs] = h
    got = rnn_kernels.unpack_gates(hp @ packed.reshape(-1, Hp).T, Hs)
    torch.testing.assert_close(got, h @ w, rtol=0, atol=1e-12)
    wb = rnn_kernels.pad_w_bwd(w)
    assert wb.shape == (Hp, 3 * Hp)
    for q in range(3):
        assert torch.equal(wb[:Hs, q * Hp:q * Hp + Hs], w[:, q * Hs:(q + 1) * Hs])
    assert int((wb != 0).sum()) == int((w != 0).sum())
