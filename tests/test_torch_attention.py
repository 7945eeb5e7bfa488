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

The bf16 backward's row routine (B6, `attend_bwd` on a cluster of CTAs a
row) is emulated by `_bwd_rows`: a dead row (dctx all zero, or no valid
position) skipped with ddp = dsc = 0, the list (valid positions and
masked ones with α ≠ 0), the ranks' contiguous ranges
(`attn_bwd_ranges`), each range's stage plan (`attn_bwd_chunks`), the
ranks' partial Σα·dα added in rank order, and each rank's partial ddp by
position class, classes and then ranks added in order. It is held to
`attn_bwd_step_plain` and the JAX `_attn_bwd_step` in interpret mode, f32
and bf16, on rows with holes, a fully masked row, rows with dctx = 0 (ddp
and dsc exactly 0 there), a single valid position and lists that do not
split evenly over 2 or 3 ranks, and to the plain version past the stage.
B7's walk over the nonzero terms (`attn_dep_kernel`, both orders over t)
is emulated by `_dep_walk` (the live positions listed first, blocks of 16,
chunks of 32 steps, only the steps with a nonzero dsc at a block position,
a zero dsc skipped): every nonzero term is taken once, and its dep equals
`attn_phase2_plain`'s (oldest first) and `decoder_seq_dep_plain`'s (newest
first) bit for bit, f32 and bf16; its dv, in the kernel's fixed order, is
within the f32 tolerance. `attn_bwd_path`, `attn_bwd_cluster` and the
walk's blocks a row (`dep_blocks`) are held as functions of the shape.

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


def _bwd_rows(ep, enc, dp, v, mask, dctx, alpha, ranks, stage_bytes):
    """csrc/attn_row.cuh's attend_bwd row by row, as a cluster of `ranks`
    CTAs walks it: a dead row (dctx all zero, or no valid position) gets
    ddp = dsc = 0; else the list (positions with mask > 0, and masked ones
    with α ≠ 0) is cut into the ranks' ranges, each range's rows of enc (dα,
    f32) then ep staged in `attn_bwd_chunks`' chunks (each entry read once a
    pass), the ranks' Σα·dα added in rank order, dsc for each range, and
    Σ dsc·(1−t²) summed by position class (i mod splits of the range's
    entries, a zero dsc skipped), classes then ranks added in order, times
    v, rounded once. dp [B, A] f32. Returns (ddp, dsc)."""
    dt = ep.dtype
    B, S, A = ep.shape
    splits = _row_splits(A)
    ddp, dsc = torch.zeros(B, A), torch.zeros(B, S)
    for b in range(B):
        dc = dctx[b].float()
        if not bool((dc != 0).any()) or not bool((mask[b] > 0).any()):
            continue  # dead: zeros, nothing of ep or enc read
        idx = [s for s in range(S) if mask[b, s] > 0 or alpha[b, s] != 0]
        parts, partials, dscs = [], [], {}
        ranges = ak.attn_bwd_ranges(len(idx), ranks)
        assert [j for j0, j1 in ranges for j in range(j0, j1)] == list(range(len(idx)))
        for j0, j1 in ranges:  # dα and each rank's Σα·dα
            ent = idx[j0:j1]
            k = ak.attn_bwd_chunks(len(ent), A, C if enc.shape[2] == C else enc.shape[2],
                                   stage_bytes)
            seen = []
            dal = torch.zeros(len(ent))
            for c in range(k["nc"]):
                i0, i1 = c * k["pc"], min(len(ent), (c + 1) * k["pc"])
                dal[i0:i1] = enc[b, ent[i0:i1]].float() @ dc
                seen += list(range(i0, i1))
            assert seen == list(range(len(ent)))
            parts.append((ent, dal, k))
            partials.append(float((alpha[b, ent] * dal).sum()) if ent else 0.0)
        tot = torch.tensor(0.0)
        for p in partials:  # rank order
            tot = tot + torch.tensor(p, dtype=torch.float32)
        rank_sums = []
        for ent, dal, k in parts:
            d = torch.where(mask[b, ent] > 0, alpha[b, ent] * (dal - tot), torch.zeros(()))
            for s, x in zip(ent, d):
                dscs[s] = x
            acc = torch.zeros(splits, A)
            seen = []
            for c in range(k["na"]):
                i0, i1 = c * k["pa"], min(len(ent), (c + 1) * k["pa"])
                for i in range(i0, i1):
                    seen.append(i)
                    if d[i] == 0:
                        continue
                    th = torch.tanh(ep[b, ent[i]].float() + dp[b])
                    acc[i % splits] += d[i] * (1.0 - th * th)
            assert seen == list(range(len(ent)))
            tot_r = acc[0]
            for cls in range(1, splits):
                tot_r = tot_r + acc[cls]
            rank_sums.append(tot_r)
        s_ = rank_sums[0]
        for r in rank_sums[1:]:
            s_ = s_ + r
        ddp[b] = s_ * v.float()
        for s, x in dscs.items():
            dsc[b, s] = x
    return ddp.to(dt), dsc


def _bwd_case(dtype, seed=13):
    """Rows of S = 16 (the JAX kernel's tile: no padding) at A = C = 128:
    0 full; 1-2 and 5-7 with holes (no mask a prefix), lists of 11, 7, 9
    and 5 valid positions, none even over 2 ranks or over 3 for most; 3 a
    row with dctx = 0; 4 fully masked (α = 1/S from the forward); 6 one
    valid position (α = 1 there, so dsc = dα − dα = 0 and ddp = 0). α from
    the plain forward."""
    rng = np.random.RandomState(seed)
    S_ = 16
    f = lambda *shape, sc=1.0: (sc * rng.randn(*shape)).astype(np.float32)  # noqa: E731
    mask = np.ones((B, S_), np.float32)
    for b, n in ((1, 11), (2, 7), (3, 10), (5, 9), (6, 1), (7, 5)):
        mask[b] = 0.0
        mask[b, np.sort(rng.choice(np.arange(1, S_), n, replace=False))] = 1.0
    mask[4] = 0.0
    arrays = dict(ep=f(B, S_, A), enc=f(B, S_, C, sc=0.3), dp=f(B, A), v=f(A, sc=0.1),
                  dctx=f(B, C, sc=0.1))
    arrays["dctx"][3] = 0.0
    tdt = getattr(torch, dtype)
    port = {k: torch.tensor(a).to(tdt) for k, a in arrays.items()}
    port["mask"] = torch.tensor(mask)
    port["alpha"] = ak.attn_fwd_plain(port["ep"], port["enc"], port["dp"], port["v"],
                                      port["mask"])[1]
    assert torch.all(port["alpha"][4] == 1.0 / S_)
    jdt = jnp.dtype(dtype)
    jax_ = {k: jnp.asarray(port[k].float().numpy()).astype(jdt) for k in arrays}
    jax_["mask"] = jnp.asarray(mask)
    jax_["alpha"] = jnp.asarray(port["alpha"].numpy())
    return port, jax_


def _bwd_close(got, want, p, dtype):
    """ddp to _TOL of the largest sum of its terms' magnitudes (ddp is
    v·Σ_S dsc·(1−t²) over a softmax gradient that sums to 0); dsc, f32, to
    1e-5 of its largest element."""
    terms = float(want[1].abs().sum(1).max() * p["v"].float().abs().max())
    _close("ddp", got[0], np.asarray(want[0], np.float32), dtype, scale=terms)
    _close("dsc", got[1], np.asarray(want[1], np.float32), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_row_walk_matches_plain_and_pallas(dtype):
    """B6's walk (`_bwd_rows`) on 1, 2 and 3 ranks (the rule's 1 at S = 16,
    and lists that do not split evenly) against attn_bwd_step_plain and the
    JAX `_attn_bwd_step` in interpret mode; the dead rows (dctx = 0, fully
    masked) and the row of one valid position exactly 0 in ddp and dsc on
    the walk's side and the plain version's."""
    p, j = _bwd_case(dtype)
    args = [p[k] for k in ("ep", "enc", "dp", "v", "mask", "dctx", "alpha")]
    want = ak.attn_bwd_step_plain(*args)
    j_ddp, j_dsc = bk._attn_bwd_step(*(j[k] for k in ("ep", "enc", "dp", "v", "mask", "dctx",
                                                      "alpha")), True)
    assert ak.attn_bwd_cluster(16) == 1
    for ranks in (1, 2, 3):
        got = _bwd_rows(*args[:2], p["dp"].float(), *args[3:], ranks, ak.ATTN_BWD_STAGE)
        assert got[0].dtype == p["ep"].dtype and got[1].dtype == torch.float32
        for ref in (want, (j_ddp, j_dsc)):
            _bwd_close(got, [r.float() if torch.is_tensor(r) else torch.tensor(np.asarray(
                r, np.float32)) for r in ref], p, dtype)
        # dead rows, and one valid position (α = 1 there: dsc = dα − dα)
        for rows in (got, want):
            assert torch.all(rows[0][[3, 4, 6]] == 0) and torch.all(rows[1][[3, 4, 6]] == 0)


def test_bwd_row_walk_past_the_stage_and_masked_alpha():
    """S = 208 at A = C = 128 on one rank: 200-odd listed rows of enc and ep
    (104 KB) pass the 45 KB stage and are streamed through its halves; a
    masked position given α ≠ 0 is listed (its dα enters Σα·dα, its dsc is
    0): the walk against the plain version, f32."""
    rng = np.random.RandomState(17)
    S_ = 208
    ep, enc = torch.tensor(rng.randn(2, S_, A), dtype=torch.float32), \
        torch.tensor(0.3 * rng.randn(2, S_, C), dtype=torch.float32)
    dp, v = torch.tensor(rng.randn(2, A), dtype=torch.float32), \
        torch.tensor(0.1 * rng.randn(A), dtype=torch.float32)
    mask = torch.tensor((rng.rand(2, S_) < 0.98).astype(np.float32))
    mask[0, 5] = 0.0
    alpha = ak.attn_fwd_plain(ep, enc, dp, v, mask)[1]
    alpha[0, 5] = 0.01  # a caller's α at a masked position
    dctx = torch.tensor(0.1 * rng.randn(2, C), dtype=torch.float32)
    n = int(((mask[0] > 0) | (alpha[0] != 0)).sum())
    k = ak.attn_bwd_chunks(n, A, C, ak.ATTN_BWD_STAGE)
    assert not k["whole"] and k["nc"] > 1 and k["na"] > 1
    want = ak.attn_bwd_step_plain(ep, enc, dp, v, mask, dctx, alpha)
    got = _bwd_rows(ep, enc, dp, v, mask, dctx, alpha, 1, ak.ATTN_BWD_STAGE)
    _bwd_close(got, want, {"v": v}, "float32")
    assert got[1][0, 5] == 0 and want[1][0, 5] == 0
    # leaving the masked position out of the list moves every dsc of the row
    off = _bwd_rows(ep, enc, dp, v, mask, dctx, alpha.masked_fill(mask == 0, 0.0), 1,
                    ak.ATTN_BWD_STAGE)
    assert float((off[1][0] - want[1][0]).abs().max()) > 1e-5 * float(want[1].abs().max())


def test_bwd_path_and_cluster_are_functions_of_the_shape():
    """attn_bwd_path: bf16 rows of a multiple of 16 bytes by bulk copies,
    others by plain loads; f32, A past the routine's 8192 and shapes past a
    block's shared memory on the first design. attn_bwd_cluster: a rank for
    every 32 positions, at most 4 (2 at the main path's S = 50). The main
    path's rows on 2 ranks: up to 25 listed positions a rank, staged whole
    up to 15 (45 KB), streamed past it (enc's chunks of 11 positions, ep's
    of 22); S = 300 on 4 ranks: 75 a rank, streamed."""
    bf, f32 = torch.bfloat16, torch.float32
    assert ak.attn_bwd_path(50, 512, 1024, bf) == ak.attn_bwd_path(300, 512, 1024, bf) \
        == ak.ATTN_BULK
    assert ak.attn_bwd_path(7, 100, 130, bf) == ak.attn_bwd_path(45, 300, 520, bf) \
        == ak.ATTN_LOADS
    assert ak.attn_bwd_path(50, 512, 1024, f32) == ak.FIRST
    assert ak.attn_bwd_path(50, 8200, 1024, bf) == ak.FIRST
    assert ak.attn_bwd_path(50, 512, 11528, bf) == ak.FIRST
    assert ak.attn_bwd_path(17000, 128, 128, bf) == ak.FIRST
    assert [ak.attn_bwd_cluster(S_) for S_ in (1, 7, 32, 33, 45, 50, 64, 65, 300)] == \
        [1, 1, 1, 2, 2, 2, 2, 3, 4]
    assert ak.attn_bwd_ranges(50, 2) == [(0, 25), (25, 50)]
    assert ak.attn_bwd_ranges(37, 2) == [(0, 19), (19, 37)]
    assert ak.attn_bwd_ranges(1, 2) == [(0, 1), (1, 1)]
    assert ak.attn_bwd_ranges(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    whole = [n for n in range(1, 26) if ak.attn_bwd_chunks(n, 512, 1024,
                                                            ak.ATTN_BWD_STAGE)["whole"]]
    assert whole == list(range(1, 16))
    ring = ak.attn_bwd_chunks(25, 512, 1024, ak.ATTN_BWD_STAGE)
    assert (ring["pc"], ring["pa"], ring["nc"], ring["na"]) == (11, 22, 3, 2)
    ring = ak.attn_bwd_chunks(75, 512, 1024, ak.ATTN_BWD_STAGE)
    assert (ring["whole"], ring["nc"], ring["na"]) == (False, 7, 4)
    assert ak.attn_bwd_chunks(0, 512, 1024, ak.ATTN_BWD_STAGE)["nc"] == 0
    # four CTAs an SM at the main path's widths: B6's 512 CTAs in one wave
    assert 4 * (ak.row_bwd_fixed_bytes(50, 512, 1024, 2) + ak.ATTN_BWD_STAGE + 1024) <= 233472
    assert ak.dep_blocks(50) == 4 and ak.dep_blocks(16) == 1 and ak.dep_blocks(17) == 2


def _dep_walk(ep, dp_seq, dsc_seq, v, newest, skip=True):
    """B7's walk (attn_dep_kernel, then attn_dv_kernel): per row, its
    positions with a nonzero dsc at some step listed first, then the rest;
    blocks of DEP_POSITIONS of that order; per block the steps in chunks of
    32 in the visiting order (newest first or oldest first), only those with
    a nonzero dsc at one of the block's live positions, and at each a zero
    dsc skipped (`skip`); each term (dsc·(1−th²))·v added in f32, op by op,
    th from the tensor the plain versions take tanh of; dv: Σ th·dsc per
    (row, block) in the walk's order, then the rows (row-major) in 8
    contiguous ranges, each summed in order, the ranges in order. Returns
    (dep [B,S,A] io dtype, dv [A] f32, the (t, b, s) terms taken)."""
    T_, B_, A_ = dp_seq.shape
    S_ = ep.shape[1]
    epf, vf = ep.float(), v.float()
    th_all = [torch.tanh(epf + dp_seq[t].float()[:, None, :]) for t in range(T_)]
    nblk = ak.dep_blocks(S_)
    dep = torch.zeros(B_, S_, A_)
    part = torch.zeros(B_ * nblk, A_)
    taken = 0
    steps = list(range(T_ - 1, -1, -1)) if newest else list(range(T_))
    for b in range(B_):
        live = [s for s in range(S_) if bool((dsc_seq[:, b, s] != 0).any())]
        order = live + [s for s in range(S_) if s not in live]
        for blk in range(nblk):
            pos = order[blk * ak.DEP_POSITIONS:(blk + 1) * ak.DEP_POSITIONS]
            lp = [s for s in pos if s in live]
            dvp = torch.zeros(A_)
            for c0 in range(0, T_, 32):
                chunk = [t for t in steps[c0:c0 + 32] if bool((dsc_seq[t, b, lp] != 0).any())]
                for t in chunk:
                    for s in lp:
                        d = dsc_seq[t, b, s]
                        if skip and d == 0:
                            continue
                        th = th_all[t][b, s]
                        dep[b, s] = dep[b, s] + d * (1.0 - th * th) * vf
                        dvp = dvp + th * d
                        taken += int(d != 0)
            part[b * nblk + blk] = dvp
    rows = B_ * nblk
    per = -(-rows // 8)
    dv = torch.zeros(A_)
    for r0 in range(0, 8 * per, per):
        s_ = torch.zeros(A_)
        for r in range(r0, min(rows, r0 + per)):
            s_ = s_ + part[r]
        dv = dv + s_
    return dep.to(ep.dtype), dv, taken


def _dep_case(dtype, seed=21):
    """B7's inputs at S = 20 (two blocks of positions) and T = 40 (two chunks
    of steps): dsc masked by ragged source lengths, a row with no nonzero
    dsc, steps at which a row's dsc is 0 (a target step past its length)."""
    rng = np.random.RandomState(seed)
    S_, T_ = 20, 40
    tdt = getattr(torch, dtype)
    ep = torch.tensor(rng.randn(B, S_, A), dtype=torch.float32).to(tdt)
    dp_seq = torch.tensor(rng.randn(T_, B, A), dtype=torch.float32).to(tdt)
    v = torch.tensor(0.1 * rng.randn(A), dtype=torch.float32).to(tdt)
    lens = rng.randint(1, S_ + 1, size=B)
    lens[0] = S_
    tlens = rng.randint(1, T_ + 1, size=B)
    mask = (np.arange(S_)[None] < lens[:, None]) & (rng.rand(B, S_) < 0.8)
    dsc = 0.01 * rng.randn(T_, B, S_) * mask[None] * (np.arange(T_)[:, None] < tlens[None])[..., None]
    dsc[:, 2] = 0.0
    return ep, dp_seq, torch.tensor(dsc, dtype=torch.float32), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dep_walk_gives_the_plain_dep_bit_for_bit(dtype):
    """`_dep_walk` oldest first equals attn_phase2_plain's dep, newest first
    decoder_seq_dep_plain's, bit for bit; it takes every nonzero term once;
    its dv is within 1e-5 of Σ|dsc| of the plain dv."""
    ep, dp_seq, dsc, v = _dep_case(dtype)
    nonzero = int((dsc != 0).sum())
    for newest, plain in ((False, ak.attn_phase2_plain), (True, ak.decoder_seq_dep_plain)):
        dep, dv, taken = _dep_walk(ep, dp_seq, dsc, v, newest)
        want = plain(ep, dp_seq, dsc, v)
        assert taken == nonzero
        assert dep.dtype == ep.dtype and torch.equal(dep, want[0])
        assert float((dv - want[1]).abs().max()) <= 1e-5 * float(dsc.abs().sum())
        assert torch.all(dep[2] == 0) and float(dep.float().abs().max()) > 0
    if dtype == "float32":  # the order matters: oldest first is not newest first
        assert not torch.equal(ak.attn_phase2_plain(ep, dp_seq, dsc, v)[0],
                               ak.decoder_seq_dep_plain(ep, dp_seq, dsc, v)[0])


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


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "enc_shape", "mask_shape", "alpha_dtype",
                                 "dctx_shape", "dsc_dtype"])
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
    elif bad == "dctx_shape":
        dctx = dctx[:, :-1]
    elif bad == "alpha_dtype":
        alpha = alpha.bfloat16()
    with pytest.raises((TypeError, ValueError)):
        if bad in ("alpha_dtype", "dctx_shape"):
            ak.attn_bwd_step(ep, enc, dp, v, mask, dctx, alpha)
        elif bad == "dsc_dtype":
            ak.attn_phase2(ep, p["dp_seq"], p["dsc_seq"].double(), v)
        else:
            ak.attn_fwd(ep, enc, dp, v, mask)
    with pytest.raises((TypeError, ValueError)):
        ak.attn_phase2(ep, p["dp_seq"][:, :-1], p["dsc_seq"], v)
    with pytest.raises((TypeError, ValueError)):
        ak.decoder_seq_dep(ep, p["dp_seq"], p["dsc_seq"][:, :, :-1], v)
