"""The fused 1x1 conv + BatchNorm unit: the hand-written Hopper kernel
(csrc/fused_conv_bn.cu), its plain PyTorch version, and `_FusedConvBNFn`,
the autograd Function over them.

Replaces the TPU kernel `_fused_kernel` / `_pallas_fwd`
(paddle_tpu/ops/fused_conv_ops.py:106-183) and its custom VJP
(`_fused_fn`, :186-247). One call computes, for x [N, Cin] rows (the
previous BN's raw output, or a normalised activation), a filter W in its
checkpoint layout [Cout, Cin] and the previous BN's [Cin] vectors pm, pi,
ps, pb:

    xn = io((x − pm)·(pi·ps) + pb), then ReLU      (the optional prologue)
    y  = io(xn · Wᵀ)                               (f32 accumulation)
    s  = Σ_rows y,   sq = Σ_rows y²                (f32, from the rounded y)

`io` rounds to the io dtype (bf16 or f32) and the prologue runs in f32,
`pi·ps` formed first, as `_prologue` (:260-271) writes it.

`fused_matmul_bn` takes CUDA tensors to the kernel, or raises; CPU tensors
to `fused_matmul_bn_plain`. There is no fallback from one to the other.

The kernel is one launch, its statistics' reduce folded in (the last CTA
to finish sums the CTAs' rows in a fixed order). `plan` deals the work: in
bf16 a persistent grid of one CTA an SM, each owning a column tile of up to
256 output channels (so for Cout <= 256 x is read once) and a contiguous
chunk of 128-row tiles; in f32 64-wide column tiles, about eight CTAs an
SM.

The kernel's eligibility is Hopper's, not the TPU's: Cin a multiple of 32
and Cout of 64, any N (tail rows masked), bf16 or f32. It admits all 36
`fused_conv_bn` calls of ResNet-50 (Cin 64..2048, Cout 64..2048), where
the TPU rule (Cin and Cout multiples of 128, a row block dividing N that
fits VMEM) admits 29.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import cuda_build

# launches of the CUDA kernel in this process; chip_smoke.py reads it
fused_conv_bn_launches = 0
# inputs the wrapper had to copy before a launch (a misaligned view);
# the stride-2 projection's subsampled view is read in place
fused_conv_bn_input_copies = 0

K_STEP = 32      # Cin's granule: the kernels' K steps take 32 channels or more
COL_GRANULE = 64  # Cout's: the narrowest column tile
ROW_TILE = 128   # kBM in csrc/fused_conv_bn.cu
_IO_DTYPES = (torch.float32, torch.bfloat16)
# CTAs a launch aims for on each SM: the bf16 kernel is persistent, one an
# SM; the f32 kernel's smaller CTAs fit several
_CTAS_PER_SM = {torch.bfloat16: 1, torch.float32: 8}


class Plan(NamedTuple):
    """How one call is dealt: column tiles of `col_tile` output channels,
    each taken by `chunks` CTAs of `tiles_per_chunk` consecutive row tiles
    (the last chunk may be shorter); grid (Cout / col_tile, chunks)."""
    col_tile: int
    chunks: int
    tiles_per_chunk: int


@functools.lru_cache(maxsize=256)
def plan(n: int, cout: int, dtype, n_sms: int) -> Plan:
    """The launch's work split for N rows and Cout channels on a card of
    `n_sms` SMs: in bf16 the widest of 256, 128, 64 that divides Cout, in
    f32 64; row tiles dealt in contiguous chunks, no chunk empty, about
    _CTAS_PER_SM CTAs an SM over the grid. Chunk c holds row tiles
    [c·tiles_per_chunk, (c+1)·tiles_per_chunk); the statistics are summed
    over chunks 0, 1, ... in that order."""
    if dtype == torch.bfloat16:
        col = next(c for c in (256, 128, 64) if cout % c == 0)
    else:
        col = COL_GRANULE
    n_tiles = math.ceil(n / ROW_TILE)
    want = max(1, min(n_tiles, (_CTAS_PER_SM[dtype] * n_sms) // (cout // col)))
    per = math.ceil(n_tiles / want)
    return Plan(col, math.ceil(n_tiles / per), per)


def fused_conv_eligible(n: int, cin: int, cout: int, dtype) -> bool:
    """Whether the kernel takes these shapes."""
    return (dtype in _IO_DTYPES and n >= 1 and cin >= K_STEP and cin % K_STEP == 0
            and cout >= COL_GRANULE and cout % COL_GRANULE == 0)


# ------------------------------------------------------------------ plain --
def prologue_plain(x, pm, pi, ps, pb, relu: bool):
    """The previous BN's normalise (+ReLU) in f32, rounded to x's dtype:
    `_prologue`'s formula, the one definition the kernel's plain version
    and the op's 4-D route share. The [C] vectors broadcast over the
    leading axes."""
    xh = (x.float() - pm) * (pi * ps) + pb
    if relu:
        xh = torch.clamp_min(xh, 0.0)
    return xh.to(x.dtype)


def sum_sq(y, dims, f32_squares: bool):
    """Per-channel sum and sum of squares of y over `dims`, summed in f32:
    the JAX package's `_sum_sq` (paddle_tpu/ops/fused_conv_ops.py:273-285).
    With `f32_squares` y is squared in f32; without, in its own dtype, so
    in bf16 each square is rounded before the sum. The kernel squares its
    rounded y in f32 whatever FLAGS.bn_bf16_stats says, as the TPU kernel
    does (paddle_tpu/ops/fused_conv_ops.py:126-131); the ops' other routes
    pass `not FLAGS.bn_bf16_stats`."""
    yf = y.float()
    return yf.sum(dims), ((yf * yf) if f32_squares else (y * y).float()).sum(dims)


def conv1x1_plain(x, w, pm=None, pi=None, ps=None, pb=None, relu: bool = True):
    """The product the kernel computes, on any device: x [..., Cin] (a view,
    any strides), w [Cout, Cin], both in the io dtype; pm, pi, ps, pb [Cin]
    f32, or None for no prologue. Returns y [N, Cout] in the io dtype,
    accumulated in f32 (the products of two bf16 values are exact in f32)
    and rounded once."""
    x2 = x.reshape(-1, x.shape[-1])
    xn = x2 if pm is None else prologue_plain(x2, pm, pi, ps, pb, relu)
    return torch.matmul(xn.float(), w.float().t()).to(x.dtype)


def fused_matmul_bn_plain(x, w, pm=None, pi=None, ps=None, pb=None, relu: bool = True):
    """The function the kernel computes: conv1x1_plain's y and its f32
    statistics. Returns (y [N, Cout] in the io dtype, s, sq [Cout] f32)."""
    y = conv1x1_plain(x, w, pm, pi, ps, pb, relu)
    return (y, *sum_sq(y, 0, f32_squares=True))


# ------------------------------------------------------------------ kernel --
def _lib():
    lib = cuda_build.load("fused_conv_bn")
    if lib.fused_conv_bn_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.fused_conv_bn_launch.argtypes = [i] * 3 + [i] * 3 + [ll] * 3 + [i] * 2 + \
            [p] * 12 + [i] * 3 + [p]
        lib.fused_conv_bn_launch.restype = ctypes.c_int
        lib.fused_conv_bn_error_string.argtypes = [i]
        lib.fused_conv_bn_error_string.restype = ctypes.c_char_p
    return lib


_tickets = {}


def _ticket(device):
    """The device's u32 counter the kernel's CTAs take tickets from: 0
    between launches (the last CTA resets it), so one serves every launch
    on the device's stream."""
    t = _tickets.get(device.index)
    if t is None:
        t = _tickets[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _as_4d(x):
    """x [..., Cin] as a [B, H, W, Cin] view (leading axes of 1 added)."""
    if x.dim() > 4:
        raise ValueError(f"fused_matmul_bn: x has {x.dim()} axes, at most 4 are taken")
    while x.dim() < 4:
        x = x.unsqueeze(0)
    return x


def _readable(x):
    """x itself if the kernel can read it in place (channels contiguous,
    every row on 16 bytes), else a contiguous copy, counted."""
    global fused_conv_bn_input_copies
    vec = 16 // x.element_size()
    if x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(
            s % vec == 0 or d == 1 for s, d in zip(x.stride()[:3], x.shape[:3])):
        return x
    fused_conv_bn_input_copies += 1
    return x.contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, w, vecs):
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"fused_matmul_bn: io dtype must be float32 or bfloat16, got {x.dtype}")
    if w.dim() != 2 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"fused_matmul_bn: w must be [Cout, {x.shape[-1]}], "
                         f"got {list(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"fused_matmul_bn: w is {w.dtype} on {w.device}, x {x.dtype} "
                        f"on {x.device}")
    for v in vecs:
        if v is not None and (v.shape != (x.shape[-1],) or v.dtype != torch.float32
                              or v.device != x.device):
            raise ValueError(f"fused_matmul_bn: the prologue vectors must be [Cin] f32 on "
                             f"{x.device}, got {list(v.shape)} {v.dtype} on {v.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_matmul_bn: unsupported device {x.device}")


def _aligned(v):
    """v itself if contiguous and on 16 bytes (the kernel reads 16 at a
    time), else a copy."""
    return v if v.is_contiguous() and v.data_ptr() % 16 == 0 else \
        v.clone(memory_format=torch.contiguous_format)


def fused_matmul_bn(x, w, pm=None, pi=None, ps=None, pb=None, relu: bool = True):
    """See fused_matmul_bn_plain for the contract. CUDA tensors launch the
    sm_90a kernel (one launch, the statistics included); CPU tensors run
    the plain version."""
    global fused_conv_bn_launches
    vecs = (pm, pi, ps, pb)
    prologue = pm is not None
    if prologue and any(v is None for v in vecs):
        raise ValueError("fused_matmul_bn: give all four prologue vectors or none")
    _check(x, w, vecs)
    if x.device.type == "cpu":
        return fused_matmul_bn_plain(x, w, pm, pi, ps, pb, relu)
    cin, cout = x.shape[-1], w.shape[0]
    x4 = _readable(_as_4d(x))
    n = x4.shape[0] * x4.shape[1] * x4.shape[2]
    if not fused_conv_eligible(n, cin, cout, x.dtype):
        raise ValueError(f"fused_matmul_bn: the kernel does not take N={n}, Cin={cin}, "
                         f"Cout={cout} ({x.dtype}); Cin must be a multiple of {K_STEP} and "
                         f"Cout of {COL_GRANULE}")
    w = _aligned(w)
    if prologue:
        vecs = tuple(_aligned(v) for v in vecs)
    pl = plan(n, cout, x.dtype, _sm_count(x.device.index))
    y = torch.empty(n, cout, dtype=x.dtype, device=x.device)
    # one f32 workspace: the CTAs' rows of Σy and Σy² [2, chunks, Cout], then s, sq
    ws = torch.empty(2 * (pl.chunks + 1) * cout, dtype=torch.float32, device=x.device)
    part = pl.chunks * cout * 4  # bytes of one of the two
    ptrs = [v.data_ptr() if prologue else None for v in vecs]
    with torch.cuda.device(x.device):
        lib = _lib()
        err = lib.fused_conv_bn_launch(
            int(x.dtype == torch.bfloat16), int(prologue), int(bool(relu)), *x4.shape[:3],
            *x4.stride()[:3], cin, cout, x4.data_ptr(), w.data_ptr(), *ptrs, y.data_ptr(),
            ws.data_ptr(), ws.data_ptr() + part, ws.data_ptr() + 2 * part,
            ws.data_ptr() + 2 * part + cout * 4, _ticket(x.device).data_ptr(), pl.col_tile,
            pl.chunks, pl.tiles_per_chunk, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_bn kernel launch failed (N={n}, Cin={cin}, "
                           f"Cout={cout}, {x.dtype}): {lib.fused_conv_bn_error_string(err).decode()}")
    fused_conv_bn_launches += 1
    s, sq = ws[-2 * cout:].view(2, cout).unbind(0)
    return y, s, sq


# ---------------------------------------------------------------- autograd --
class _FusedConvBNFn(torch.autograd.Function):
    """The counterpart of `_fused_fn`'s custom VJP. Forward: the kernel on
    a CUDA tensor, the plain version on a CPU one; x [B, H, W, Cin] (a
    view) gives y [B, H, W, Cout]. Backward: the plain torch transcription
    of `_fused_fn.bwd` (:192-243) on both devices, as the JAX package
    computes it outside its kernel:

    - the statistics' cotangents fold into dy_c = dy + ds + 2·dsq·y, op by
      op in the io dtype;
    - the prologue is recomputed in f32 with the backward's own formula
      x·g + (pb − pm·g), g = pi·ps, and the ReLU mask is xh32 > 0;
    - dW = dy_cᵀ·xn_c and dxn = dy_c·W, matrix products in the io dtype;
    - two per-channel f32 reductions of dxh give dpm, dpi, dps and dpb.
    """

    @staticmethod
    def forward(ctx, x, w, pm, pi, ps, pb, relu):
        y, s, sq = fused_matmul_bn(x, w, pm, pi, ps, pb, relu)
        ctx.save_for_backward(x, w, pm, pi, ps, pb, y)
        ctx.relu = relu
        return y.reshape(*x.shape[:-1], w.shape[0]), s, sq

    @staticmethod
    def backward(ctx, dy, ds, dsq):
        x, w, pm, pi, ps, pb, y = ctx.saved_tensors
        dt = x.dtype
        cin = x.shape[-1]
        dy = dy.reshape(y.shape).to(dt)
        dy_c = dy + ds.to(dt) + (2.0 * dsq).to(dt) * y
        prologue = pm is not None
        if prologue:
            g = pi * ps
            xh32 = (x.float() * g + (pb - pm * g)).reshape(-1, cin)
            xh = xh32.to(dt)
            if ctx.relu:
                pos = xh32 > 0
                xn_c = torch.where(pos, xh, torch.zeros((), dtype=dt, device=xh.device))
            else:
                xn_c = xh
        else:
            xn_c = x.reshape(-1, cin)
        dw = torch.matmul(dy_c.t(), xn_c).to(w.dtype)
        dxn = torch.matmul(dy_c, w)
        if not prologue:
            return dxn.reshape(x.shape), dw, None, None, None, None, None
        dxh = torch.where(pos, dxn, torch.zeros((), dtype=dt, device=dxn.device)) \
            if ctx.relu else dxn
        dx = dxh * g.to(dt)
        dxh32 = dxh.float()
        r0 = dxh32.sum(0)
        r1 = (dxh32 * x.reshape(-1, cin).float()).sum(0)
        rc = r1 - pm * r0  # Σ dxh·(x − pm) without centring x
        return dx.reshape(x.shape), dw, -r0 * g, rc * ps, rc * pi, r0, None


def fused_conv_bn_fused(x, w, pm=None, pi=None, ps=None, pb=None, relu: bool = True):
    """Differentiable fused unit over x [B, H, W, Cin] (any view) and w
    [Cout, Cin]: (y [B, H, W, Cout], s, sq), through the kernel (on CPU
    tensors, through its plain version)."""
    return _FusedConvBNFn.apply(x, w, pm, pi, ps, pb, bool(relu))
