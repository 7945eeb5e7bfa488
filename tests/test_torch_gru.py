"""GRU forward: the port's plain version (ops/rnn_kernels.gru_fwd_plain)
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
`test_bf16_bounds_reject_rounding_elsewhere` holds the bounds to that."""

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
