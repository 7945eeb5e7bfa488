"""Flash attention, forward and backward: the hand-written Hopper kernels
(csrc/flash_attn.cu), their plain PyTorch versions, and `flash_fused`, the
autograd Function over the three.

Replaces the TPU kernel behind `_flash_kernel`
(paddle_tpu/ops/flash_ops.py:160), the jax library's Pallas flash
attention: its forward pallas_call, and the custom VJP's dK/dV kernel
(`_flash_attention_bwd_dkv`) and dQ kernel (`_flash_attention_bwd_dq`)
around Di = Σ(dO∘O), computed outside them (`_flash_attention_bwd`).

Every tensor is [B,T,H,D] (the op's layout, read through its strides), but
LSE and Di, [B,H,T] f32. The numerics are the TPU kernel's: scores and
softmax in f32, P rounded to the io dtype before P·V and dV = PᵀdO, dS
rounded to it before dK and dQ, the products accumulated in f32 and each
output rounded once.

`flash_fwd`, `flash_bwd_dkv` and `flash_bwd_dq` take CUDA tensors to the
kernels, or raise; CPU tensors to the plain versions. There is no fallback
from one to the other. In bf16 io all three kernels run on wgmma with TMA
(see `bwd_schedule` and `q_schedule` for the blocks they walk); in f32 io
on mma.sync's fragment layout with f32 FMAs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

# launches of the CUDA kernels in this process; chip_smoke.py reads them
flash_fwd_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dq_launches = 0

HEAD_DIMS = (64, 128)
FLASH_BLOCK = 64  # keys a forward block stages (kBwdCols in csrc/flash_attn.cu)
FWD_ROWS = 128  # query rows a bf16 forward CTA owns, 64 each warpgroup (kFwdRows)
BWD_ROWS = 64  # rows a backward CTA owns (kBwdRows), and an f32 forward CTA
BWD_COLS = 64  # rows of each tile a backward CTA streams (kBwdCols)
_IO_DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------------------ plain --
def _scores(q, k, causal):
    """f32 scores [B,H,Tq,Tk] scaled by 1/sqrt(D), and the visible mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    Tq, Tk = s.shape[-2:]
    if not causal:
        return s, None
    mask = torch.arange(Tq, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)[None, :]
    return s, mask


def _probs(q, k, lse, causal):
    s, mask = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    return p if mask is None else torch.where(mask, p, torch.zeros((), device=p.device))


def flash_fwd_plain(q, k, v, causal: bool):
    """The function the forward kernel computes, on any device: f32 scores,
    and the online softmax over blocks of FLASH_BLOCK keys, as the kernel
    walks them: the running row max m, P = exp(s - m) rounded to the io
    dtype before P·V, the accumulator and the sum l of the unrounded P
    rescaled by exp(m_old - m) at each block, O = acc · (1/l). (The bf16
    kernel computes the same exponentials in base 2, scale·log2 e folded
    into the scores.) Returns (O [B,T,H,D] io dtype, LSE = m + log l
    [B,H,T] f32)."""
    dt = q.dtype
    s, mask = _scores(q, k, causal)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    B, H, Tq, Tk = s.shape
    vf = v.float()
    m = torch.full((B, H, Tq, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Tq, 1), device=q.device)
    acc = torch.zeros((B, H, Tq, q.shape[-1]), device=q.device)
    for k0 in range(0, Tk, FLASH_BLOCK):
        sb = s[..., k0:k0 + FLASH_BLOCK]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))  # finite: key 0 is always visible
        alpha = torch.exp(m - m_new)
        p = torch.exp(sb - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), vf[:, k0:k0 + FLASH_BLOCK])
        acc = acc * alpha + pv
        m = m_new
    o = (acc * (1.0 / l)).permute(0, 2, 1, 3)
    return o.to(dt), (m + torch.log(l))[..., 0]


def flash_bwd_dkv_plain(q, k, v, do, lse, di, causal: bool):
    """The function the dK/dV kernel computes: P = exp(s - LSE) in f32,
    dV = io(P)ᵀ dO, dS = (dP - Di)·P·scale with dP = dO Vᵀ, dK = io(dS)ᵀ Q.
    Returns (dK, dV) in the io dtype."""
    dt = q.dtype
    p = _probs(q, k, lse, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    ds = _ds(q, v, do, di, p)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float())
    return dk.to(dt), dv.to(dt)


def flash_bwd_dq_plain(q, k, v, do, lse, di, causal: bool):
    """The function the dQ kernel computes: dQ = io(dS) K, dS as in
    flash_bwd_dkv_plain. Returns dQ in the io dtype."""
    dt = q.dtype
    ds = _ds(q, v, do, di, _probs(q, k, lse, causal))
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(dt).float(), k.float()).to(dt)


def _ds(q, v, do, di, p):
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return (dp - di[..., None]) * p * (1.0 / math.sqrt(q.shape[-1]))


def flash_di(o, do):
    """Di = Σ_d dO∘O in f32, [B,H,T]: one torch op, as `_flash_attention_bwd`
    computes it in jnp outside its kernels."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


# --------------------------------------------------------------- schedule --
@functools.lru_cache(maxsize=64)
def bwd_schedule(T: int, causal: bool, rows: int = BWD_ROWS, cols: int = BWD_COLS):
    """The blocks the backward kernels walk, as csrc/flash_attn.cu's
    dkv_first, dq_last, dkv_masked and dq_masked compute them.

    Returns {"dkv": ctas, "dq": ctas}, each CTA of one head in launch order
    (blockIdx.y) as (own block, ((other block, masked), ...)) in walk order.
    A dK/dV CTA owns keys [rows·kb, rows·(kb+1)) and walks query tiles of
    `cols` from the first that holds a visible pair (causal: the tile of
    its first key) to the last; a dQ CTA owns queries and walks key tiles
    from 0 to the last that holds a visible pair (causal: the tile of its
    last query). Causal CTAs with the most blocks come first: key block 0,
    the last query block. A block is masked, and only then evaluates the
    causal test and the T bound, when it holds a row or column past T or,
    causal, a pair whose key comes after its query."""
    n_rows, n_cols = -(-T // rows), -(-T // cols)
    dkv = []
    for kb in range(n_rows):
        k0 = kb * rows
        first = k0 // cols if causal else 0
        dkv.append((kb, tuple(
            (qt, k0 + rows > T or qt * cols + cols > T or (causal and k0 + rows - 1 > qt * cols))
            for qt in range(first, n_cols))))
    dq = []
    for qb in reversed(range(n_rows)):
        q0 = qb * rows
        last = min(n_cols - 1, (q0 + rows - 1) // cols) if causal else n_cols - 1
        dq.append((qb, tuple(
            (kt, q0 + rows > T or kt * cols + cols > T or (causal and kt * cols + cols - 1 > q0))
            for kt in range(last + 1))))
    return {"dkv": tuple(dkv), "dq": tuple(dq)}


def q_schedule(T: int, causal: bool, rows: int = BWD_ROWS, cols: int = FLASH_BLOCK):
    """The walk of the kernels that own query blocks, the bf16 forward and
    dQ: bwd_schedule's "dq" CTAs, each (query block, ((key block, masked),
    ...)) in launch order, the heaviest causal CTAs first. The forward's
    online softmax walks the key blocks in this order, FLASH_BLOCK keys
    each, as flash_fwd_plain does. Its CTAs own FWD_ROWS queries and stream
    the walk of rows=FWD_ROWS; each of its two warpgroups walks its own
    64-row block's entry of rows=64 (causal: the first stops one tile
    short), with that entry's mask flags."""
    return bwd_schedule(T, causal, rows, cols)["dq"]


# ------------------------------------------------------------------ kernel --
class _View(ctypes.Structure):
    """A [B,T,H,D] tensor as csrc/flash_attn.cu's `View` takes it."""

    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("st", ctypes.c_longlong), ("sh", ctypes.c_longlong)]


def _view(t):
    return ctypes.byref(_View(t.data_ptr(), *t.stride()[:3]))


def _lib():
    lib = cuda_build.load("flash_attn")
    if lib.flash_fwd_launch.argtypes is None:
        head = [ctypes.c_int] * 6 + [ctypes.c_float]
        ptr = ctypes.c_void_p
        lib.flash_fwd_launch.argtypes = head + [ctypes.c_int] + [ptr] * 6  # n_ctas first
        lib.flash_bwd_dkv_launch.argtypes = head + [ctypes.c_int] + [ptr] * 9  # n_ctas first
        lib.flash_bwd_dq_launch.argtypes = head + [ctypes.c_int] + [ptr] * 8
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch, lib.flash_bwd_dq_launch):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t):
    """t itself if the kernels can read it in place, else a contiguous copy:
    d contiguous, the data on 16 bytes and every stride a multiple of 16
    bytes, as the f32 kernels' 16-byte loads and the bf16 kernels' tensor
    maps (a 16-byte aligned base, strides in multiples of 16 bytes) need."""
    vec = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def _check(fn, q, named):
    if q.dim() != 4:
        raise ValueError(f"{fn}: q must be [B,T,H,D], got {tuple(q.shape)}")
    B, T, H, D = q.shape
    if min(B, T, H) < 1:
        raise ValueError(f"{fn}: empty input {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim must be one of {HEAD_DIMS}, got {D}")
    if q.dtype not in _IO_DTYPES:
        raise TypeError(f"{fn}: io dtype must be float32 or bfloat16, got {q.dtype}")
    for name, t, shape, dtype in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {list(shape)}, got {list(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {q.device}")


def _io_named(q, *pairs):
    return [(n, t, tuple(q.shape), q.dtype) for n, t in pairs]


def _stat_named(q, *pairs):
    B, T, H, _ = q.shape
    return [(n, t, (B, H, T), torch.float32) for n, t in pairs]


def _launch(name, q, causal, *args):
    B, T, H, D = q.shape
    with torch.cuda.device(q.device):
        lib = _lib()
        err = getattr(lib, f"{name}_launch")(
            int(q.dtype == torch.bfloat16), int(bool(causal)), B, T, H, D,
            1.0 / math.sqrt(D), *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (B={B}, T={T}, H={H}, D={D}, "
                           f"{q.dtype}): {lib.flash_error_string(err).decode()}")


def flash_fwd(q, k, v, causal: bool):
    """Attention forward; see flash_fwd_plain for the contract. CUDA tensors
    launch the sm_90a kernel; CPU tensors run the plain version."""
    global flash_fwd_launches
    _check("flash_fwd", q, _io_named(q, ("k", k), ("v", v)))
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    q, k, v = (_aligned(t) for t in (q, k, v))
    B, T, H, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rows = FWD_ROWS if q.dtype == torch.bfloat16 else BWD_ROWS
    ctas = len(q_schedule(T, bool(causal), rows))  # the grid's CTAs a head
    _launch("flash_fwd", q, causal, ctas, *(_view(t) for t in (q, k, v, o)), lse.data_ptr())
    flash_fwd_launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, di, causal: bool):
    """dK and dV; see flash_bwd_dkv_plain. CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    global flash_bwd_dkv_launches
    _check("flash_bwd_dkv", q, _io_named(q, ("k", k), ("v", v), ("do", do))
           + _stat_named(q, ("lse", lse), ("di", di)))
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, di, causal)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lse, di = lse.contiguous(), di.contiguous()
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ctas = len(bwd_schedule(q.shape[1], bool(causal))["dkv"])  # the grid's CTAs a head
    _launch("flash_bwd_dkv", q, causal, ctas, *(_view(t) for t in (q, k, v, do)),
            lse.data_ptr(), di.data_ptr(), _view(dk), _view(dv))
    flash_bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, causal: bool):
    """dQ; see flash_bwd_dq_plain. CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    global flash_bwd_dq_launches
    _check("flash_bwd_dq", q, _io_named(q, ("k", k), ("v", v), ("do", do))
           + _stat_named(q, ("lse", lse), ("di", di)))
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, di, causal)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lse, di = lse.contiguous(), di.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ctas = len(q_schedule(q.shape[1], bool(causal)))
    _launch("flash_bwd_dq", q, causal, ctas, *(_view(t) for t in (q, k, v, do)),
            lse.data_ptr(), di.data_ptr(), _view(dq))
    flash_bwd_dq_launches += 1
    return dq


class _FlashFn(torch.autograd.Function):
    """The counterpart of the library's `_flash_attention` custom VJP: the
    forward kernel saves O and LSE; the backward computes Di in one torch op
    and runs the dK/dV and dQ kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        di = flash_di(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, di, ctx.causal)
        return dq, dk, dv, None


def flash_fused(q, k, v, causal: bool):
    """Differentiable attention over [B,T,H,D] through the three kernels
    (on CPU tensors, through their plain versions)."""
    return _FlashFn.apply(q, k, v, bool(causal))
