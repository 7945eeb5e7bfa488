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
(`test_bwd_bf16_bound_rejects_a_dh_carry_in_f32`)."""

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


def _inputs(B, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, 3 * H).astype(np.float32)
    w = (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    b = (0.1 * rng.randn(3 * H)).astype(np.float32)
    lens = rng.randint(1, T + 1, size=B)
    lens[0] = T
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


def _bwd_case(B, seed, reverse, dtype, carry_f32=False):
    """(Pallas dx, dW), (port dx, dW) as f32 numpy, on one seeded case."""
    x, w, b, mask = _inputs(B, seed)
    rng = np.random.RandomState(seed + 100)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    xt = torch.tensor(x).to(tdt) + torch.tensor(b).to(tdt)
    wt, mt = torch.tensor(w).to(tdt), torch.tensor(mask)
    dh = torch.tensor(0.1 * rng.randn(T, B, H), dtype=torch.float32).to(tdt)
    dhT = torch.tensor(0.1 * rng.randn(B, H), dtype=torch.float32).to(tdt)
    h_seq, _ = rnn_kernels.gru_fwd_plain(xt, mt, wt, reverse)
    h_prev, ur, c, rh = rnn_kernels.gru_bwd_inputs(xt, wt, h_seq, reverse)
    args = (ur, c, h_prev, rh, dh, mt, wt, dhT)
    if carry_f32:
        got = rnn_kernels.gru_bwd_plain(*(a.float() if a.is_floating_point() else a
                                          for a in args), reverse=reverse)
    else:
        got = rnn_kernels.gru_bwd_plain(*args, reverse=reverse)
        assert got[0].dtype == tdt and got[1].shape == (H, 3 * H)
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)  # noqa: E731
    jx, jm, jh, jdh = to_j(xt), jnp.asarray(mask), to_j(h_seq), to_j(dh)
    if reverse:  # gru_fused's flip in and out
        jx, jm, jh, jdh = jx[::-1], jm[::-1], jh[::-1], jdh[::-1]
    j_dx, j_dw = pallas_kernels._gru_bwd_pallas(jx, jm, to_j(wt), jh, jdh, to_j(dhT))
    if reverse:
        j_dx = j_dx[::-1]
    want = [np.asarray(a, np.float32) for a in (j_dx, j_dw)]
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
