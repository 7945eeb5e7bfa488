"""GRU forward over a whole sequence: the hand-written Hopper kernel
(csrc/gru_fwd.cu) and its plain PyTorch version.

Replaces the TPU kernel `_gru_kernel` / `_gru_pallas_raw`
(paddle_tpu/ops/pallas_kernels.py:457-515) and the forward half of
`gru_fused` (:676-691). The kernel is bound by its T dependent steps, not
by bytes or FLOPs: each step needs all of the previous h, so the card
meets at a grid barrier twice a step. Its design keeps each CTA's slice of
W in shared memory for all T steps and h in L2 (see the source's note).

`gru_fwd` takes a CUDA tensor to the kernel, or raises; a CPU tensor to
`gru_fwd_plain`. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# launches of the CUDA kernel in this process; chip_smoke.py reads it
gru_fwd_launches = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)


def gru_fwd_plain(x, mask, w, reverse: bool = False):
    """The function `_gru_kernel` computes, step by step on any device.

    x [T,B,3H] io dtype with the bias already added, mask [T,B], w [H,3H]
    (cast to the io dtype). Gate math in f32; rh and the carried h are
    rounded to the io dtype where the TPU kernel rounds them.
    Returns (h_seq [T,B,H], h_T [B,H]) in the io dtype."""
    T, B, H3 = x.shape
    H = H3 // 3
    dt = x.dtype
    wf = w.to(dt).float()
    w_ur, w_c = wf[:, : 2 * H], wf[:, 2 * H :]
    mf = mask.float()
    h = torch.zeros(B, H, dtype=dt, device=x.device)
    h_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        xp = x[t].float()
        hf = h.float()
        ur = torch.sigmoid(xp[:, : 2 * H] + hf @ w_ur)
        u, r = ur[:, :H], ur[:, H:]
        rh = (r * hf).to(dt).float()
        c = torch.tanh(xp[:, 2 * H :] + rh @ w_c)
        hn = (1 - u) * hf + u * c
        m = mf[t][:, None]
        h = (m * hn + (1 - m) * hf).to(dt)
        h_seq[t] = h
    return h_seq, h


def _lib():
    lib = cuda_build.load("gru_fwd")
    fn = lib.gru_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gru_fwd_error_string.argtypes = [ctypes.c_int]
        lib.gru_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, mask, w):
    if x.dim() != 3 or x.shape[2] % 3:
        raise ValueError(f"gru_fwd: x must be [T,B,3H], got {tuple(x.shape)}")
    T, B, H3 = x.shape
    H = H3 // 3
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"gru_fwd: empty input {tuple(x.shape)}")
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"gru_fwd: io dtype must be float32 or bfloat16, got {x.dtype}")
    if tuple(w.shape) != (H, H3):
        raise ValueError(f"gru_fwd: w must be [{H},{H3}], got {tuple(w.shape)}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"gru_fwd: mask must be [{T},{B}], got {tuple(mask.shape)}")
    for name, t in (("x", x), ("mask", mask), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"gru_fwd: {name} is on {t.device}, x on {x.device}")


def gru_fwd(x, mask, w, reverse: bool = False):
    """Whole-sequence masked GRU forward; see gru_fwd_plain for the
    contract. CUDA tensors launch the sm_90a kernel; CPU tensors run the
    plain version."""
    global gru_fwd_launches
    _check(x, mask, w)
    if x.device.type == "cpu":
        return gru_fwd_plain(x, mask, w, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"gru_fwd: unsupported device {x.device}")
    T, B, H3 = x.shape
    H = H3 // 3
    dt = x.dtype
    x = x.contiguous()
    w = w.to(dt).contiguous()
    mask = mask.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        lib = _lib()
        h_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
        h_T = torch.empty(B, H, dtype=dt, device=x.device)
        hbuf = torch.zeros(2, B, H, dtype=dt, device=x.device)
        rh = torch.empty(B, H, dtype=dt, device=x.device)
        err = lib.gru_fwd_launch(
            int(dt == torch.bfloat16), x.data_ptr(), mask.data_ptr(), w.data_ptr(),
            h_seq.data_ptr(), h_T.data_ptr(), hbuf.data_ptr(), rh.data_ptr(),
            T, B, H, int(bool(reverse)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"gru_fwd kernel launch failed (T={T}, B={B}, H={H}, {dt}): "
            f"{lib.gru_fwd_error_string(err).decode()}")
    gru_fwd_launches += 1
    return h_seq, h_T
