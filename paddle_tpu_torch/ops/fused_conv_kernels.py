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

The kernel's eligibility is Hopper's, not the TPU's: Cin a multiple of the
kernel's 32-deep K tile and Cout of its 64-wide column tile, any N (tail
rows masked), bf16 or f32. It admits all 36 `fused_conv_bn` calls of
ResNet-50 (Cin 64..2048, Cout 64..2048), where the TPU rule (Cin and Cout
multiples of 128, a row block dividing N that fits VMEM) admits 29.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

# launches of the CUDA kernels in this process; chip_smoke.py reads them
fused_conv_bn_launches = 0
fused_conv_bn_reduce_launches = 0
# inputs the wrapper had to copy before a launch (a misaligned view);
# the stride-2 projection's subsampled view is read in place
fused_conv_bn_input_copies = 0

K_TILE = 32     # kK in csrc/fused_conv_bn.cu
COL_TILE = 64   # kBN
ROW_TILE = 128  # kBM
_IO_DTYPES = (torch.float32, torch.bfloat16)
# CTAs a launch aims for on each SM (two fit by registers); the row tiles
# are dealt to CTAs in contiguous chunks to reach about this many
_CTAS_PER_SM = 8


def fused_conv_eligible(n: int, cin: int, cout: int, dtype) -> bool:
    """Whether the kernel takes these shapes."""
    return (dtype in _IO_DTYPES and n >= 1 and cin >= K_TILE and cin % K_TILE == 0
            and cout >= COL_TILE and cout % COL_TILE == 0)


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
        lib.fused_conv_bn_launch.argtypes = [i] * 3 + [i] * 3 + [ll] * 3 + [i] * 2 + [p] * 9 + \
            [i] * 2 + [p]
        lib.fused_conv_bn_reduce_launch.argtypes = [p, p, i, i, p, p, p]
        for fn in (lib.fused_conv_bn_launch, lib.fused_conv_bn_reduce_launch):
            fn.restype = ctypes.c_int
        lib.fused_conv_bn_error_string.argtypes = [i]
        lib.fused_conv_bn_error_string.restype = ctypes.c_char_p
    return lib


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


def _row_chunks(n_tiles: int, col_tiles: int, device) -> tuple:
    """(chunks, tiles a chunk): the row tiles dealt in contiguous chunks,
    about _CTAS_PER_SM CTAs an SM over the grid."""
    sms = _sm_count(device.index)
    want = max(1, min(n_tiles, math.ceil(_CTAS_PER_SM * sms / col_tiles)))
    per = math.ceil(n_tiles / want)
    return math.ceil(n_tiles / per), per


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


def fused_matmul_bn(x, w, pm=None, pi=None, ps=None, pb=None, relu: bool = True):
    """See fused_matmul_bn_plain for the contract. CUDA tensors launch the
    sm_90a kernel and its statistics reduce (stats_reduce); CPU tensors
    run the plain version."""
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
                         f"Cout={cout} ({x.dtype}); Cin must be a multiple of {K_TILE} and "
                         f"Cout of {COL_TILE}")
    w = w if w.is_contiguous() and w.data_ptr() % 16 == 0 else w.contiguous()
    if prologue:
        vecs = tuple(v.contiguous() for v in vecs)
    chunks, per = _row_chunks(math.ceil(n / ROW_TILE), cout // COL_TILE, x.device)
    y = torch.empty(n, cout, dtype=x.dtype, device=x.device)
    part = torch.empty(2, chunks, cout, dtype=torch.float32, device=x.device)
    ptrs = [v.data_ptr() if prologue else None for v in vecs]
    with torch.cuda.device(x.device):
        lib = _lib()
        err = lib.fused_conv_bn_launch(
            int(x.dtype == torch.bfloat16), int(prologue), int(bool(relu)), *x4.shape[:3],
            *x4.stride()[:3], cin, cout, x4.data_ptr(), w.data_ptr(), *ptrs, y.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), chunks, per,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_bn kernel launch failed (N={n}, Cin={cin}, "
                           f"Cout={cout}, {x.dtype}): {lib.fused_conv_bn_error_string(err).decode()}")
    fused_conv_bn_launches += 1
    s, sq = stats_reduce(part)
    return y, s, sq


def stats_reduce_plain(part):
    """part [2, chunks, Cout] f32, the CTAs' per-chunk sums of y and y²:
    the sums over the chunks, [2, Cout]."""
    return part.sum(1)


def stats_reduce(part):
    """The second launch of the unit on a CUDA workspace (the chunks
    summed in chunk order, the same bits on every run); the plain version
    on a CPU one."""
    global fused_conv_bn_reduce_launches
    if part.dim() != 3 or part.shape[0] != 2 or part.dtype != torch.float32:
        raise ValueError(f"stats_reduce: part must be [2, chunks, Cout] f32, got "
                         f"{list(part.shape)} {part.dtype}")
    if part.device.type == "cpu":
        return stats_reduce_plain(part)
    part = part.contiguous()
    _, chunks, cout = part.shape
    stats = torch.empty(2, cout, dtype=torch.float32, device=part.device)
    with torch.cuda.device(part.device):
        lib = _lib()
        err = lib.fused_conv_bn_reduce_launch(part[0].data_ptr(), part[1].data_ptr(), chunks,
                                              cout, stats[0].data_ptr(), stats[1].data_ptr(),
                                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv_bn_reduce kernel launch failed (chunks={chunks}, "
                           f"Cout={cout}): {lib.fused_conv_bn_error_string(err).decode()}")
    fused_conv_bn_reduce_launches += 1
    return stats


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
