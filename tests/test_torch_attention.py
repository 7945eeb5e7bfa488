"""The Bahdanau attention kernels of the NMT decoder's training step: the
port's plain versions (ops/attention_kernels.py) against the JAX
package's Pallas kernels in interpret mode, and the decoder's autograd
Function against jax.vjp of `fused_attention_decoder`.

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
