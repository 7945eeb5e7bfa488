"""GRU over a whole sequence, forward and backward: the hand-written
Hopper kernels (csrc/gru_fwd.cu, csrc/gru_bwd.cu), their plain PyTorch
versions, and `gru_fused`, the autograd Function over the two.

Replaces the TPU kernels `_gru_kernel` / `_gru_pallas_raw` and
`_gru_bwd_kernel` / `_gru_bwd_pallas` (paddle_tpu/ops/pallas_kernels.py:
457-673) and `gru_fused` / `_gru_core` (:676-716). Both kernels are bound
by their T dependent steps, not by bytes or FLOPs: each step needs all of
the previous step's h (or dh), so the card meets at a grid barrier twice a
step. Their design keeps each CTA's slice of W in shared memory for all T
steps and the per-step exchange in L2 (see the sources' notes).

`gru_fwd` and `gru_bwd` take CUDA tensors to the kernel, or raise; CPU
tensors to the plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# launches of the CUDA kernels in this process; chip_smoke.py reads them
gru_fwd_launches = 0
gru_bwd_launches = 0

# above this H the backward leaves dW to a batched product outside the
# kernel, as _gru_bwd_pallas does (_GRU_FUSED_DW_MAX_H, pallas_kernels.py:605)
GRU_FUSED_DW_MAX_H = 640

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


# ------------------------------------------------------------- backward --
def gru_bwd_inputs(x, w, h_seq, reverse: bool = False):
    """The batched recompute (no recurrence) the backward kernel reads,
    as _gru_bwd_pallas does it (pallas_kernels.py:612-625): h_prev (the h
    each step started from; for `reverse` the one after it in time),
    ur_pre = x_ur + h_prev@W_ur, rh = io(sigmoid(r_pre)·h_prev) and
    c_pre = x_c + rh@W_c, each product accumulated in f32 and rounded to
    the io dtype. x is [T,B,3H] with the bias added, w [H,3H] in x's dtype."""
    H = h_seq.shape[2]
    zeros = torch.zeros_like(h_seq[:1])
    h_prev = torch.cat([h_seq[1:], zeros] if reverse else [zeros, h_seq[:-1]])
    ur_pre = x[..., : 2 * H] + torch.matmul(h_prev, w[:, : 2 * H])
    rh = (torch.sigmoid(ur_pre[..., H:].float()) * h_prev.float()).to(x.dtype)
    c_pre = x[..., 2 * H :] + torch.matmul(rh, w[:, 2 * H :])
    return h_prev, ur_pre, c_pre, rh


def _dw_outside(h_prev, rh, dx):
    """dW as _gru_bwd_pallas computes it past GRU_FUSED_DW_MAX_H: batched
    products of the saved inputs and dx (f32 accumulation, one rounding)."""
    T, B, H = h_prev.shape
    hp = h_prev.reshape(T * B, H).T
    return torch.cat([torch.matmul(hp, dx[..., : 2 * H].reshape(T * B, 2 * H)),
                      torch.matmul(rh.reshape(T * B, H).T, dx[..., 2 * H :].reshape(T * B, H))],
                     dim=1)


def gru_bwd_plain(ur_pre, c_pre, h_prev, rh, dh_seq, mask, w, dhT, reverse: bool = False):
    """The function `_gru_bwd_kernel` computes, step by step on any device.

    All tensors but mask [T,B] are in the io dtype: ur_pre [T,B,2H], c_pre,
    h_prev, rh and dh_seq [T,B,H], w [H,3H], dhT [B,H]. Walks t from T-1
    down to 0 (from 0 up for `reverse`). Gate math in f32; the dh carry is
    rounded to the io dtype each step, dc_pre and dur before their products
    (drh stays f32), and dW, accumulated in f32, once at the end.
    Returns (dx [T,B,3H], dW [H,3H]) in the io dtype."""
    T, B, H = h_prev.shape
    dt = h_prev.dtype
    wf = w.to(dt).float()
    w_ur, w_c = wf[:, : 2 * H], wf[:, 2 * H :]
    mf = mask.float()
    fuse_dw = H <= GRU_FUSED_DW_MAX_H
    dw = torch.zeros(H, 3 * H, dtype=torch.float32, device=h_prev.device)
    dx = torch.empty(T, B, 3 * H, dtype=dt, device=h_prev.device)
    dh = dhT.to(dt)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        ur = torch.sigmoid(ur_pre[t].float())
        u, r = ur[:, :H], ur[:, H:]
        c = torch.tanh(c_pre[t].float())
        hp = h_prev[t].float()
        m = mf[t][:, None]
        dh_total = dh_seq[t].float() + dh.float()
        dh_raw = m * dh_total
        dc_act = dh_raw * u
        du_act = dh_raw * (c - hp)
        dh_prev = (1 - m) * dh_total + dh_raw * (1 - u)
        dc_pre = dc_act * (1 - c * c)
        dcq = dc_pre.to(dt).float()
        drh = dcq @ w_c.T
        dh_prev = dh_prev + drh * r
        du_pre = du_act * u * (1 - u)
        dr_pre = drh * hp * r * (1 - r)
        durq = torch.cat([du_pre, dr_pre], dim=1).to(dt).float()
        dh_prev = dh_prev + durq @ w_ur.T
        dx[t] = torch.cat([du_pre, dr_pre, dc_pre], dim=1).to(dt)
        dh = dh_prev.to(dt)
        if fuse_dw:
            dw[:, : 2 * H] += hp.T @ durq
            dw[:, 2 * H :] += rh[t].float().T @ dcq
    if not fuse_dw:
        return dx, _dw_outside(h_prev, rh, dx)
    return dx, dw.to(dt)


def _bwd_lib():
    lib = cuda_build.load("gru_bwd")
    fn = lib.gru_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gru_bwd_error_string.argtypes = [ctypes.c_int]
        lib.gru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd(ur_pre, c_pre, h_prev, rh, dh_seq, mask, w, dhT):
    if h_prev.dim() != 3:
        raise ValueError(f"gru_bwd: h_prev must be [T,B,H], got {tuple(h_prev.shape)}")
    T, B, H = h_prev.shape
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"gru_bwd: empty input {tuple(h_prev.shape)}")
    dt = h_prev.dtype
    if dt not in _IO_DTYPES:
        raise TypeError(f"gru_bwd: io dtype must be float32 or bfloat16, got {dt}")
    want = {"ur_pre": (T, B, 2 * H), "c_pre": (T, B, H), "rh": (T, B, H),
            "dh_seq": (T, B, H), "w": (H, 3 * H), "dhT": (B, H)}
    for name, t in (("ur_pre", ur_pre), ("c_pre", c_pre), ("rh", rh),
                    ("dh_seq", dh_seq), ("w", w), ("dhT", dhT)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"gru_bwd: {name} must be {list(want[name])}, "
                             f"got {list(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"gru_bwd: {name} is {t.dtype}, h_prev {dt}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"gru_bwd: mask must be [{T},{B}], got {tuple(mask.shape)}")
    for name, t in (("ur_pre", ur_pre), ("c_pre", c_pre), ("rh", rh), ("dh_seq", dh_seq),
                    ("mask", mask), ("w", w), ("dhT", dhT)):
        if t.device != h_prev.device:
            raise ValueError(f"gru_bwd: {name} is on {t.device}, h_prev on {h_prev.device}")


def gru_bwd(ur_pre, c_pre, h_prev, rh, dh_seq, mask, w, dhT, reverse: bool = False):
    """Reverse-time masked GRU backward; see gru_bwd_plain for the
    contract. CUDA tensors launch the sm_90a kernel; CPU tensors run the
    plain version."""
    global gru_bwd_launches
    _check_bwd(ur_pre, c_pre, h_prev, rh, dh_seq, mask, w, dhT)
    if h_prev.device.type == "cpu":
        return gru_bwd_plain(ur_pre, c_pre, h_prev, rh, dh_seq, mask, w, dhT, reverse)
    if h_prev.device.type != "cuda":
        raise ValueError(f"gru_bwd: unsupported device {h_prev.device}")
    T, B, H = h_prev.shape
    dt = h_prev.dtype
    fuse_dw = H <= GRU_FUSED_DW_MAX_H
    args = [t.contiguous() for t in (ur_pre, c_pre, h_prev, rh, dh_seq)]
    mask = mask.to(torch.float32).contiguous()
    w, dhT = w.contiguous(), dhT.contiguous()
    with torch.cuda.device(h_prev.device):
        lib = _bwd_lib()
        dx = torch.empty(T, B, 3 * H, dtype=dt, device=h_prev.device)
        dw = torch.empty(H, 3 * H, dtype=dt, device=h_prev.device)
        dcp = torch.empty(B, H, dtype=dt, device=h_prev.device)
        dur = torch.empty(B, 2 * H, dtype=dt, device=h_prev.device)
        err = lib.gru_bwd_launch(
            int(dt == torch.bfloat16), *(a.data_ptr() for a in args), mask.data_ptr(),
            w.data_ptr(), dhT.data_ptr(), dx.data_ptr(), dw.data_ptr(), dcp.data_ptr(),
            dur.data_ptr(), T, B, H, int(bool(reverse)), int(fuse_dw),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"gru_bwd kernel launch failed (T={T}, B={B}, H={H}, {dt}): "
            f"{lib.gru_bwd_error_string(err).decode()}")
    gru_bwd_launches += 1
    if not fuse_dw:
        dw = _dw_outside(args[2], args[3], dx)
    return dx, dw


class _GruFn(torch.autograd.Function):
    """The counterpart of `_gru_core` (pallas_kernels.py:694-716): the
    forward kernel, and a backward that recomputes the pre-activations in
    batched products and runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, mask, w, reverse):
        h_seq, h_T = gru_fwd(x, mask, w, reverse=reverse)
        ctx.save_for_backward(x, mask, w, h_seq)
        ctx.reverse = reverse
        return h_seq, h_T

    @staticmethod
    def backward(ctx, dh_seq, dhT):
        x, mask, w, h_seq = ctx.saved_tensors
        h_prev, ur_pre, c_pre, rh = gru_bwd_inputs(x, w, h_seq, ctx.reverse)
        dt = x.dtype
        dx, dw = gru_bwd(ur_pre, c_pre, h_prev, rh, dh_seq.to(dt), mask, w,
                         dhT.to(dt), reverse=ctx.reverse)
        return dx, None, dw, None


def gru_fused(x, mask, w, bias=None, reverse: bool = False):
    """Differentiable whole-sequence GRU (zero initial state, sigmoid/tanh):
    the bias joins x in the io dtype and w is cast to it before the kernels,
    as gru_fused does (pallas_kernels.py:681-683), so the bias's gradient is
    autograd's sum of dx. Returns (h_seq [T,B,H], h_T [B,H])."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return _GruFn.apply(x, mask, w.to(x.dtype), bool(reverse))
