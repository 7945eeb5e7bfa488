"""The Bahdanau attention kernels of the NMT decoder's training step: the
port's plain versions (ops/attention_kernels.py) against the JAX
package's Pallas kernels in interpret mode, and the decoder's autograd
Function against jax.vjp of `fused_attention_decoder`.

The bf16 forward's row routine (csrc/attn_row.cuh, B5's kernel and B9's
phase 2) cannot run here: `_rows_attention` emulates its walk (the listed
valid positions, `attn_row_chunks`' staging whole or through the two
halves of the stage, ctx by position class) and is held to the plain
version and the JAX `_attn_fwd` on a non-prefix mask, a fully masked row
and an S past the 96 KB stage, and to the plain version on rows the
routine copies by plain loads; `attn_fwd_path` is held as a function of
the shape.

Widths put the JAX side on its kernels (A and C multiples of 128, B a
multiple of 8) with S = 10, which the JAX side pads to 16 (masked) and
the port does not pad; the padded columns are dropped before comparing.

Tolerances. Kernels, relative to the largest element of each output, or
for a sum whose terms cancel (ddp and dv over a softmax gradient that
sums to 0, dep over T) to the largest sum of its terms' magnitudes: f32
1e-5 (the same f32 arithmetic summed in another order); bf16 1e-2 (an f32
sum near a bf16 rounding boundary may round one ulp, 2^-8, apart), except
for the outputs written in f32 (alpha, dsc, dv), which are f32 arithmetic
on the same bf16 inputs and keep 1e-5 (measured: 3.3e-7 at most). The
decoder, at the tolerances of tests/test_bahdanau_kernels.py, where the
JAX package holds its kernels to its scan: f32 h_seq within 2e-5 and all
nine gradients within 5e-4 relative plus 5e-4 of the largest element;
bf16 h_seq within 3e-2 and the gradients of enc and Wx within 6e-2.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu.flags import FLAGS  # noqa: E402
from paddle_tpu.ops import bahdanau_kernels as bk  # noqa: E402
from paddle_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from test_bahdanau_kernels import _make_inputs  # noqa: E402

B, S, SP, A, C, T = 8, 10, 16, 128, 128, 5
_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _case(dtype, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *shape, sc=1.0: (sc * rng.randn(*shape)).astype(np.float32)  # noqa: E731
    lens = rng.randint(2, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    arrays = dict(ep=f(B, S, A), enc=f(B, S, C, sc=0.3), dp=f(B, A), v=f(A, sc=0.1),
                  dctx=f(B, C, sc=0.1), dp_seq=f(T, B, A),
                  dsc_seq=f(T, B, S, sc=0.01) * mask[None])
    tdt = getattr(torch, dtype)
    port = {k: torch.tensor(a).to(tdt if k != "dsc_seq" else torch.float32)
            for k, a in arrays.items()}
    port["mask"] = torch.tensor(mask)
    jdt = jnp.dtype(dtype)
    pad = lambda a, axis: np.pad(a, [(0, SP - S) if i == axis else (0, 0)  # noqa: E731
                                     for i in range(a.ndim)])
    jax_ = {k: jnp.asarray(port[k].float().numpy()).astype(jdt) for k in ("dp", "v", "dctx",
                                                                            "dp_seq")}
    for k in ("ep", "enc"):
        jax_[k] = jnp.asarray(pad(port[k].float().numpy(), 1)).astype(jdt)
    jax_["mask"] = jnp.asarray(pad(mask, 1))
    jax_["dsc_seq"] = jnp.asarray(pad(arrays["dsc_seq"], 2))
    return port, jax_


def _close(name, got, want, dtype, scale=None):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() if scale is None else scale
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= _TOL[dtype] * scale, (name, np.abs(got - want).max() / scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_fwd_plain_matches_pallas(dtype):
    p, j = _case(dtype)
    ctx, alpha = ak.attn_fwd_plain(p["ep"], p["enc"], p["dp"], p["v"], p["mask"])
    j_ctx, j_alpha = bk._attn_fwd(j["ep"], j["enc"], j["dp"], j["v"], j["mask"], True)
    assert ctx.dtype == p["ep"].dtype and alpha.dtype == torch.float32
    _close("ctx", ctx, j_ctx, dtype)
    _close("alpha", alpha, np.asarray(j_alpha)[:, :S], "float32")
    assert np.all(np.asarray(j_alpha)[:, S:] == 0)  # the padding the port leaves out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_bwd_step_plain_matches_pallas(dtype):
    p, j = _case(dtype, seed=1)
    _, alpha = ak.attn_fwd_plain(p["ep"], p["enc"], p["dp"], p["v"], p["mask"])
    ddp, dsc = ak.attn_bwd_step_plain(p["ep"], p["enc"], p["dp"], p["v"], p["mask"],
                                      p["dctx"], alpha)
    j_alpha = jnp.asarray(np.pad(alpha.numpy(), [(0, 0), (0, SP - S)]))
    j_ddp, j_dsc = bk._attn_bwd_step(j["ep"], j["enc"], j["dp"], j["v"], j["mask"],
                                     j["dctx"], j_alpha, True)
    terms = float(dsc.abs().sum(1).max() * p["v"].float().abs().max())
    _close("ddp", ddp, j_ddp, dtype, scale=terms)
    _close("dsc", dsc, np.asarray(j_dsc)[:, :S], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_phase2_plain_matches_pallas(dtype):
    p, j = _case(dtype, seed=2)
    dep, dv = ak.attn_phase2_plain(p["ep"], p["dp_seq"], p["dsc_seq"], p["v"])
    j_dep, j_dv = bk._attn_phase2(j["ep"], j["dp_seq"], j["dsc_seq"], j["v"], C, True)
    dsc = p["dsc_seq"].abs()
    _close("dep", dep, np.asarray(j_dep, np.float32)[:, :S],
           dtype, scale=float(dsc.sum(0).max() * p["v"].float().abs().max()))
    _close("dv", dv, j_dv, "float32", scale=float(dsc.sum()))


def _row_splits(C, threads=256):
    """attn_row::attend's ctx position classes: a thread owns 8 columns;
    where the columns' groups leave threads over, the positions go to the
    classes i mod splits (at most 8), added in class order at the end."""
    G = -(-C // 8)
    return min(8, threads // G) if 2 * G <= threads else 1


def _rows_attention(ep, enc, dp, v, mask, stage_bytes):
    """csrc/attn_row.cuh's routine row by row, as it walks the stage: the
    valid positions listed in order (all of them for a fully masked row,
    whose scores are all -1e9), the listed rows of ep for the scores and
    of enc for ctx staged in `attn_row_chunks`' chunks (each listed
    position read once in each pass), the softmax over the listed scores,
    ctx summed in f32 by position class (i mod _row_splits) and the classes
    added in order, rounded once. dp [B, A] f32. Returns (ctx, alpha)."""
    dt = ep.dtype
    B, S, A = ep.shape
    C = enc.shape[2]
    splits = _row_splits(C)
    ctx, alpha = torch.zeros(B, C), torch.zeros(B, S)
    for b in range(B):
        idx = [s for s in range(S) if mask[b, s] > 0]
        scores = bool(idx)
        idx = idx or list(range(S))
        n = len(idx)
        k = ak.attn_row_chunks(n, scores, A, C, stage_bytes)
        assert k["pa"] >= 1 and k["pc"] >= 1
        seen_a, seen_c, sc = [], [], torch.full((n,), -1e9)
        for c in range(k["na"]):  # ep's chunks: the scores
            i0, i1 = c * k["pa"], min(n, (c + 1) * k["pa"])
            rows = ep[b, idx[i0:i1]].float()
            sc[i0:i1] = (torch.tanh(rows + dp[b]) * v.float()).sum(-1)
            seen_a += list(range(i0, i1))
        if scores:
            e = torch.exp(sc - sc.max())
            al = e / e.sum()
        else:
            al = torch.full((n,), 1.0 / S)
        alpha[b, idx] = al
        w = al.to(dt).float()
        acc = torch.zeros(splits, C)
        for c in range(k["nc"]):  # enc's chunks: ctx, class by class
            i0, i1 = c * k["pc"], min(n, (c + 1) * k["pc"])
            for i in range(i0, i1):
                acc[i % splits] += w[i] * enc[b, idx[i]].float()
            seen_c += list(range(i0, i1))
        assert seen_a == (list(range(n)) if scores else []) and seen_c == list(range(n))
        tot = acc[0]
        for cls in range(1, splits):
            tot = tot + acc[cls]
        ctx[b] = tot
    return ctx.to(dt), alpha


# S past the stage: at A = C = 128 the rows of 208 valid positions take
# 106 KB, past the 96 KB stage, so the routine streams them
_S_LONG = 208


def _row_case(kind, dtype, seed=7):
    """Rows for the row routine's cases, S a multiple of 16 (the JAX
    kernel's tile: no padding, so a fully masked row is uniform over S on
    both sides): "non-prefix" masks with holes; "fully masked", a row with
    no valid position beside non-prefix ones; "past the stage", S = 208
    with rows of 192 to 208 valid positions."""
    rng = np.random.RandomState(seed)
    S_ = _S_LONG if kind == "past the stage" else 16
    f = lambda *shape, sc=1.0: (sc * rng.randn(*shape)).astype(np.float32)  # noqa: E731
    if kind == "past the stage":
        mask = (rng.rand(B, S_) < 0.98).astype(np.float32)
        mask[0] = 1.0
    else:
        mask = (rng.rand(B, S_) < 0.6).astype(np.float32)
        mask[:, 0], mask[0, 3] = 0.0, 0.0  # no row's mask a prefix
        mask[0, 5] = 1.0
        if kind == "fully masked":
            mask[2] = 0.0
    arrays = dict(ep=f(B, S_, A), enc=f(B, S_, C, sc=0.3), dp=f(B, A), v=f(A, sc=0.1))
    tdt = getattr(torch, dtype)
    port = {k: torch.tensor(a).to(tdt) for k, a in arrays.items()}
    port["mask"] = torch.tensor(mask)
    jdt = jnp.dtype(dtype)
    jax_ = {k: jnp.asarray(port[k].float().numpy()).astype(jdt) for k in arrays}
    jax_["mask"] = jnp.asarray(mask)
    return port, jax_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["non-prefix", "fully masked", "past the stage"])
def test_row_walk_matches_plain_and_pallas(kind, dtype):
    """The row routine's walk (`_rows_attention`: the listed positions,
    the stage's chunks at attn_fwd_row_kernel's 96 KB, the ctx classes)
    against attn_fwd_plain and the JAX `_attn_fwd` in interpret mode, with
    the tolerances above."""
    p, j = _row_case(kind, dtype)
    ep, enc, dp, v, mask = (p[k] for k in ("ep", "enc", "dp", "v", "mask"))
    S_ = ep.shape[1]
    chunks = [ak.attn_row_chunks(int(m.sum()) or S_, bool(m.sum()), A, C, ak.ATTN_ROW_STAGE)
              for m in mask]
    if kind == "past the stage":
        assert not any(k["whole"] for k in chunks) and all(k["nc"] > 1 for k in chunks)
    else:
        assert all(k["whole"] for k in chunks)
    ctx, alpha = _rows_attention(ep, enc, dp.float(), v, mask, ak.ATTN_ROW_STAGE)
    want = ak.attn_fwd_plain(ep, enc, dp, v, mask)
    j_ctx, j_alpha = bk._attn_fwd(j["ep"], j["enc"], j["dp"], j["v"], j["mask"], True)
    assert ctx.dtype == ep.dtype and alpha.dtype == torch.float32
    for ref_ctx, ref_alpha in ((want[0].float().numpy(), want[1].numpy()), (j_ctx, j_alpha)):
        _close("ctx", ctx, ref_ctx, dtype)
        _close("alpha", alpha, ref_alpha, "float32")
    if kind == "fully masked":
        assert torch.all(alpha[2] == 1.0 / S_)
    assert torch.all(alpha[mask == 0] == 0) or kind == "fully masked"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_walk_by_loads_matches_plain(dtype):
    """Rows of A = 100 and C = 130 (200 and 260 bytes in bf16: no bulk
    copy), a non-prefix mask and a fully masked row: the walk on zero-padded
    rows against the plain version."""
    rng = np.random.RandomState(11)
    B_, S_, A_, C_ = 5, 23, 100, 130
    dt = getattr(torch, dtype)
    f = lambda *shape, sc=1.0: torch.tensor(sc * rng.randn(*shape), dtype=torch.float32).to(dt)  # noqa
    mask = torch.tensor((rng.rand(B_, S_) < 0.5).astype(np.float32))
    mask[1] = 0.0
    mask[0, 0] = 0.0
    ep, enc, dp, v = f(B_, S_, A_), f(B_, S_, C_, sc=0.3), f(B_, A_), f(A_, sc=0.1)
    assert ak.attn_fwd_path(S_, A_, C_, torch.bfloat16) == ak.ATTN_LOADS
    ctx, alpha = _rows_attention(ep, enc, dp.float(), v, mask, ak.ATTN_ROW_STAGE)
    want = ak.attn_fwd_plain(ep, enc, dp, v, mask)
    _close("ctx", ctx, want[0].float().numpy(), dtype)
    _close("alpha", alpha, want[1].numpy(), "float32")


def test_attn_fwd_path_is_a_function_of_the_shape():
    """attn_fwd_path: bf16 rows of a multiple of 16 bytes by bulk copies,
    others by plain loads; f32, C past the routine's 8192 and shapes past a
    block's shared memory on the first design. The main path's rows (S=50,
    A=512, C=1024) of 10-50 valid positions: whole up to 32, streamed past."""
    bf, f32 = torch.bfloat16, torch.float32
    assert ak.attn_fwd_path(50, 512, 1024, bf) == ak.ATTN_BULK
    assert ak.attn_fwd_path(7, 100, 130, bf) == ak.attn_fwd_path(45, 300, 520, bf) == ak.ATTN_LOADS
    assert ak.attn_fwd_path(300, 512, 1024, bf) == ak.ATTN_BULK
    assert ak.attn_fwd_path(50, 512, 1024, f32) == ak.FIRST
    assert ak.attn_fwd_path(50, 512, 8200, bf) == ak.FIRST
    assert ak.attn_fwd_path(17000, 128, 128, bf) == ak.FIRST
    whole = [n for n in range(1, 51) if ak.attn_row_chunks(n, True, 512, 1024,
                                                          ak.ATTN_ROW_STAGE)["whole"]]
    assert whole == list(range(1, 33))
    ring = ak.attn_row_chunks(300, True, 512, 1024, ak.ATTN_ROW_STAGE)
    assert (ring["pa"], ring["pc"], ring["na"], ring["nc"]) == (48, 24, 7, 13)
    assert _row_splits(1024) == 2 and _row_splits(130) == 8 and _row_splits(2048) == 1


def _decoder_args(dtype):
    args = _make_inputs(T=T)
    if dtype == "bfloat16":
        args = tuple(a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a for a in args)
    return args


def _port_args(args):
    out = []
    for a in args:
        t = torch.tensor(np.asarray(a, np.float32))
        out.append(t if a.dtype == jnp.bool_ else t.to(getattr(torch, str(a.dtype))))
    out[2] = out[2].bool()
    return out


_ARGNUMS = (0, 1, 3, 5, 6, 7, 8, 9, 10)
_NAMES = ["enc_b", "enc_proj", "trg_b", "h0", "wa_dec", "v_att", "wx", "wh", "bias"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_function_matches_jax_vjp(dtype, monkeypatch):
    monkeypatch.setattr(FLAGS, "fused_attention_interpret", True)
    bk.reset_dispatch_stats()
    args = _decoder_args(dtype)
    diff = [args[i] for i in _ARGNUMS]

    def f(*d):
        full = list(args)
        for i, a in zip(_ARGNUMS, d):
            full[i] = a
        return bk.fused_attention_decoder(*full)

    h_j, vjp = jax.vjp(f, *diff)
    assert bk.dispatch_stats["fused_calls"] >= 1
    r = np.sin(np.arange(np.prod(h_j.shape)).reshape(h_j.shape) * 1e-2).astype(np.float32)
    g_j = vjp(jnp.asarray(r).astype(h_j.dtype))
    assert bk.dispatch_stats["scan_bwd"] >= 1, bk.dispatch_stats

    pa = _port_args(args)
    leaves = [pa[i].requires_grad_(True) for i in _ARGNUMS]
    before = (ak.attn_fwd_launches, ak.attn_bwd_step_launches, ak.attn_phase2_launches)
    h_p = ak.fused_attention_decoder(*pa)
    (h_p.float() * torch.tensor(r)).sum().backward()
    assert (ak.attn_fwd_launches, ak.attn_bwd_step_launches, ak.attn_phase2_launches) == before
    assert h_p.dtype == pa[0].dtype
    h_j = np.asarray(h_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(h_p.detach().numpy(), h_j, rtol=2e-5, atol=2e-5)
        names = _NAMES
    else:
        np.testing.assert_allclose(h_p.detach().float().numpy(), h_j, rtol=3e-2, atol=3e-2)
        names = ["enc_b", "wx"]
    tol = 5e-4 if dtype == "float32" else 6e-2
    for name, g, leaf in zip(_NAMES, g_j, leaves):
        if name not in names:
            continue
        g = np.asarray(g, np.float32)
        scale = max(1e-3 if dtype == "float32" else 1.0, float(np.abs(g).max()))
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), g, rtol=tol, atol=tol * scale,
                                   err_msg=f"grad {name}")


def test_cpu_wrappers_run_plain_and_launch_nothing():
    p, _ = _case("float32")
    before = (ak.attn_fwd_launches, ak.attn_bwd_step_launches, ak.attn_phase2_launches)
    ctx, alpha = ak.attn_fwd(p["ep"], p["enc"], p["dp"], p["v"], p["mask"])
    want = ak.attn_fwd_plain(p["ep"], p["enc"], p["dp"], p["v"], p["mask"])
    assert torch.equal(ctx, want[0]) and torch.equal(alpha, want[1])
    got = ak.attn_bwd_step(p["ep"], p["enc"], p["dp"], p["v"], p["mask"], p["dctx"], alpha)
    want = ak.attn_bwd_step_plain(p["ep"], p["enc"], p["dp"], p["v"], p["mask"], p["dctx"], alpha)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ak.attn_phase2(p["ep"], p["dp_seq"], p["dsc_seq"], p["v"])
    want = ak.attn_phase2_plain(p["ep"], p["dp_seq"], p["dsc_seq"], p["v"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ak.attn_fwd_launches, ak.attn_bwd_step_launches, ak.attn_phase2_launches) == before


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "enc_shape", "mask_shape", "alpha_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    p, _ = _case("float32")
    ep, enc, dp, v, mask, dctx = (p[k] for k in ("ep", "enc", "dp", "v", "mask", "dctx"))
    alpha = torch.full((B, S), 1.0 / S)
    if bad == "dtype":
        ep, enc, dp, v, dctx = (t.half() for t in (ep, enc, dp, v, dctx))
    elif bad == "mixed_dtype":
        enc = enc.bfloat16()
    elif bad == "enc_shape":
        enc = enc[:, :-1]
    elif bad == "mask_shape":
        mask = mask.T
    else:
        alpha = alpha.bfloat16()
    with pytest.raises((TypeError, ValueError)):
        if bad == "alpha_dtype":
            ak.attn_bwd_step(ep, enc, dp, v, mask, dctx, alpha)
        else:
            ak.attn_fwd(ep, enc, dp, v, mask)
    with pytest.raises((TypeError, ValueError)):
        ak.attn_phase2(ep, p["dp_seq"][:, :-1], p["dsc_seq"], v)
