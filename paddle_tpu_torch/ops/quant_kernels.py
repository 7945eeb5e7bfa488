"""The int8 GEMM (B12) and the quantized ops around it.

`quant_matmul(xq, wq)`: int8 [M, K] × int8 [K, N] → int32 [M, N], an exact
sum. It replaces the TPU kernel `_quant_matmul_pallas`
(paddle_tpu/ops/quant_kernels.py:61) with the hand-written Hopper kernels
of csrc/quant_matmul.cu for CUDA tensors, and runs `quant_matmul_plain`
for CPU tensors; there is no fallback from one to the other. Unlike the
JAX dispatch, which hands shapes outside its TPU tile model to an XLA
reference, the kernels take every shape with K up to QMM_MAX_K:
`kernel_route` sends each shape, before any launch, to the wgmma kernel
(s8 wgmma fed by TMA, on the weight's K-major copy that `kmajor_weight`
keeps once per weight on the card) where tensor maps can describe it, and
to the kept mma.sync kernel, which reads the weight as it lies, elsewhere.
Below 64 rows most of the wgmma tile is empty, but the route is kept
there too: the mma.sync kernel walks all of K in each of its few CTAs,
and at M = 8, K = 8192 it is several times slower (chip_smoke.py's phase
27 times both routes at each shape).

The ops `quantized_mul` and `quantized_matmul` (the rewrites of `mul` and
`matmul` sites, quant/convert.py) round where the JAX ops round: the
activation is quantized against its calibrated scale as
clip(round(f32(x) / x_scale), ±127) with an IEEE division (a 0-dim tensor
divisor: torch turns division by a Python scalar on the card into a
reciprocal multiply) and round half to even; the epilogue computes
f32(acc) · f32(x_scale · w_scale[n]), the two scales multiplied first in
f32, and casts once to the amp dtype (f32 without amp).

`quantize_weight` and `act_scale` run at convert time, in numpy, and give
the JAX package's bits.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from .. import amp
from ..core.registry import register_op
from . import cuda_build

INT8_MAX = 127.0
# |acc| <= K·128² must stay below 2³¹
QMM_MAX_K = 131071
_QMM_TILE_N = 128  # columns a CTA of the mma.sync route owns (kBN in csrc/quant_matmul.cu)
_MAX_GRID_Y = 65535

WGMMA, MMA_SYNC = "wgmma", "mma.sync"

# launches of the CUDA kernels in this process, in all and by route, and
# the K-major weight copies made; chip_smoke.py reads them
quant_matmul_launches = 0
quant_matmul_routes = {WGMMA: 0, MMA_SYNC: 0}
kmajor_copies = 0


# ------------------------------------------------------------------ plain --
def quant_matmul_plain(xq, wq):
    """The function the kernel computes, on any device: the product in
    float64, exact because every partial sum is an integer below
    K·128² < 2⁵³ (CUDA has no integer matmul)."""
    return torch.matmul(xq.double(), wq.double()).to(torch.int32)


# ----------------------------------------------------------- the routes --
def kernel_route(M: int, K: int, N: int, aligned: bool = True) -> str:
    """The kernel a CUDA call of this shape launches: WGMMA where TMA's
    tensor maps can describe the operands (their row strides, K bytes and
    4·N bytes, multiples of 16, and `aligned`: 16-byte aligned bases),
    else MMA_SYNC. A pure function of the shape, decided before any
    launch."""
    if aligned and M >= 1 and K >= 16 and K % 16 == 0 and N >= 4 and N % 4 == 0:
        return WGMMA
    return MMA_SYNC


# K-major copies of weights, {(storage pointer, offset, shape, device): (a
# weak reference to the weight's storage, the weight's _version, the copy)}
_KMAJOR = {}


def kmajor_weight(wq):
    """wq [K, N] as the wgmma route reads it, [N, K] contiguous: made once
    per weight and kept while its storage lives. A weight replaced (a new
    storage, even at a freed one's address) or written in place (its
    _version moves) gets a new copy. The key is the storage, not the tensor
    object: tensors compare elementwise, and the executor re-wraps a
    persistable in a new tensor (detach) after every run, which shares the
    storage and the version counter. Copies of freed weights are dropped
    when the next copy is made."""
    global kmajor_copies
    key = (wq.untyped_storage().data_ptr(), wq.storage_offset(), tuple(wq.shape), wq.device)
    hit = _KMAJOR.get(key)
    if hit is not None and not hit[0].expired() and hit[1] == wq._version:
        return hit[2]
    for k in [k for k, v in _KMAJOR.items() if v[0].expired()]:
        del _KMAJOR[k]
    copy = wq.t().contiguous()
    _KMAJOR[key] = (StorageWeakRef(wq.untyped_storage()), wq._version, copy)
    kmajor_copies += 1
    return copy


# ------------------------------------------------------------------ kernel --
def _lib():
    lib = cuda_build.load("quant_matmul")
    if lib.quant_matmul_launch.argtypes is None:
        ptr = ctypes.c_void_p
        for fn in (lib.quant_matmul_launch, lib.quant_matmul_tc_launch):
            fn.argtypes = [ptr, ptr, ptr] + [ctypes.c_int] * 3 + [ptr]
            fn.restype = ctypes.c_int
        lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(xq, wq):
    for name, t in (("xq", xq), ("wq", wq)):
        if t.dtype != torch.int8:
            raise TypeError(f"quant_matmul: {name} must be int8, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"quant_matmul: {name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    if xq.device != wq.device:
        raise ValueError(f"quant_matmul: xq is on {xq.device}, wq on {wq.device}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_matmul: unsupported device {xq.device}")
    (M, K), (K2, N) = xq.shape, wq.shape
    if K != K2:
        raise ValueError(f"quant_matmul: xq is [{M}, {K}] but wq is [{K2}, {N}]")
    if K > QMM_MAX_K:
        raise ValueError(f"quant_matmul: K={K} exceeds {QMM_MAX_K}, where the int32 sum "
                         "could overflow")
    if kernel_route(M, K, N) == MMA_SYNC and math.ceil(N / _QMM_TILE_N) > _MAX_GRID_Y:
        raise ValueError(f"quant_matmul: N={N} exceeds {_MAX_GRID_Y * _QMM_TILE_N}")


def quant_matmul(xq, wq):
    """int8 [M, K] × int8 [K, N] → int32 [M, N]. CUDA tensors launch the
    sm_90a kernel `kernel_route` names; CPU tensors run the plain version."""
    global quant_matmul_launches
    _check(xq, wq)
    if xq.device.type == "cpu":
        return quant_matmul_plain(xq, wq)
    (M, K), N = xq.shape, wq.shape[1]
    out = torch.empty(M, N, dtype=torch.int32, device=xq.device)
    if M == 0 or N == 0:
        return out
    route = kernel_route(M, K, N, aligned=xq.data_ptr() % 16 == 0)
    with torch.cuda.device(xq.device):
        lib = _lib()
        if route == WGMMA:
            launch, b = lib.quant_matmul_tc_launch, kmajor_weight(wq)
        else:
            launch, b = lib.quant_matmul_launch, wq
        err = launch(xq.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed ({route} route, M={M}, K={K}, "
                           f"N={N}): {lib.quant_matmul_error_string(err).decode()}")
    quant_matmul_launches += 1
    quant_matmul_routes[route] += 1
    return out


# ------------------------------------------------------------------- ops ---
def _quantize_act(x, x_scale):
    """clip(round(f32(x) / x_scale), ±127) as int8, against the scale
    calibrated at convert time."""
    xf = x.float()
    q = torch.round(xf / torch.full((), x_scale, dtype=torch.float32, device=x.device))
    return q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def _dequant_epilogue(acc, x_scale, w_scale, out_dtype):
    """acc int32 [M, N] → out_dtype [M, N]: one f32 scale a column."""
    s = torch.full((), x_scale, dtype=torch.float32, device=acc.device) * w_scale
    return (acc.float() * s).to(out_dtype)


def _quantized(ctx, x2):
    """The op's int8 product and epilogue on a 2-D activation."""
    wq, w_scale = ctx.input("Y"), ctx.input("Scale")
    x_scale = ctx.attr("x_scale", 1.0)
    acc = quant_matmul(_quantize_act(x2, x_scale), wq)
    return _dequant_epilogue(acc, x_scale, w_scale, amp.amp_dtype(ctx) or torch.float32)


@register_op("quantized_mul")
def quantized_mul_kernel(ctx):
    """The int8 rewrite of `mul`: X, a float activation flattened to 2-D by
    x_num_col_dims, quantizes against the `x_scale` attr; Y is the int8
    [K, N] payload; Scale the f32 scale of each of its columns."""
    x = ctx.input("X")
    xd = ctx.attr("x_num_col_dims", 1)
    xs = tuple(x.shape)
    out = _quantized(ctx, x.reshape(math.prod(xs[:xd]), -1))
    ctx.set_output("Out", out.reshape(xs[:xd] + (out.shape[1],)))


@register_op("quantized_matmul")
def quantized_matmul_kernel(ctx):
    """The int8 rewrite of a 2-D `matmul` whose Y is a persistable weight
    (a transpose_Y is applied to the payload at convert time)."""
    ctx.set_output("Out", _quantized(ctx, ctx.input("X")))


# ----------------------------------------------------- convert-time helpers --
def quantize_weight(w: np.ndarray):
    """Per-output-channel symmetric int8 quantization of a [K, N] weight:
    (int8 payload, f32 scale [N]). Runs once, at convert time."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0, absmax / INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[None, :]), -INT8_MAX, INT8_MAX).astype(np.int8)
    return q, scale


def act_scale(absmax: float) -> float:
    """Calibrated activation scale from a recorded absmax range."""
    return float(absmax) / INT8_MAX if absmax > 0 else 1.0
