"""GRU over a whole sequence, forward and backward: the hand-written
Hopper kernels (csrc/gru_fwd.cu, csrc/gru_bwd.cu), their plain PyTorch
versions, and `gru_fused`, the autograd Function over the two.

Replaces the TPU kernels `_gru_kernel` / `_gru_pallas_raw` and
`_gru_bwd_kernel` / `_gru_bwd_pallas` (paddle_tpu/ops/pallas_kernels.py:
457-673) and `gru_fused` / `_gru_core` (:676-716). Both kernels are bound
by their T dependent steps, not by bytes or FLOPs: each step's products
need all of the previous step's h (or the gate gradients of every unit),
so CTAs meet at a barrier twice a step. Their design keeps each CTA's slice
of W in shared memory for all T steps and the per-step exchange in L2 (see
the sources' notes).

In bf16 both run on the tensor cores on the LSTM kernels' partition
(lstm_kernels): a CTA owns UNITS_PER_CTA hidden units of a group of
ROWS_PER_TILE-row batch tiles, with barriers among the group's CTAs only.
The forward reads W in the packed layout `pack_w` makes: for each group of
16 units, u and r of one unit side by side (so one mma.sync accumulator
lane holds both), then c's 16 columns (`packed_columns`), K-contiguous,
H padded to Hp with zeros. It exchanges h and then io(r·h) each step. The
backward reads W padded by `lstm_kernels.pad_w_bwd` ([Hp, 3·Hp]), exchanges
[du | dc] and then dr each step, and takes dW off the recurrence: a second
kernel behind the same launch computes it as one product over all T·B
rows. The f32 kernels read W as it is.

`gru_fwd` and `gru_bwd` take CUDA tensors to the kernel, or raise; CPU
tensors to the plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .lstm_kernels import ROWS_PER_TILE, UNITS_PER_CTA, pad_w_bwd, padded_units

# launches of the CUDA kernels in this process; chip_smoke.py reads them
gru_fwd_launches = 0
gru_bwd_launches = 0

# above this H the backward leaves dW to a batched product outside the
# kernel, as _gru_bwd_pallas does (_GRU_FUSED_DW_MAX_H, pallas_kernels.py:605)
GRU_FUSED_DW_MAX_H = 640

_IO_DTYPES = (torch.float32, torch.bfloat16)

# kCols in csrc/gru_fwd.cu: the packed columns of a group of UNITS_PER_CTA
# units, u and r in pairs, then c
PACKED_COLUMNS = 3 * UNITS_PER_CTA


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


def packed_columns(H: int):
    """The bf16 forward's packed column order: for packed column (group, n),
    n < PACKED_COLUMNS, the column of W [H, 3H] it holds, or -1 where its
    unit is padding. Within a group, n = 8·uq + 2·r + gate (gate 0 u, 1 r)
    holds unit 4·uq + r, so warp quad uq's n-tile gives mma.sync's
    accumulator lane r u and r of one unit; n = 32 + i holds c of unit i.
    Returns a [groups·48] long tensor."""
    groups = padded_units(H) // UNITS_PER_CTA
    # axes of the u, r part: group, uq, r, gate (the packed order)
    grp, uq, r, gate = torch.meshgrid(torch.arange(groups), torch.arange(UNITS_PER_CTA // 4),
                                      torch.arange(4), torch.arange(2), indexing="ij")
    unit = grp * UNITS_PER_CTA + uq * 4 + r
    ur = torch.where(unit < H, gate * H + unit, torch.full_like(unit, -1)).reshape(groups, -1)
    cu = torch.arange(groups)[:, None] * UNITS_PER_CTA + torch.arange(UNITS_PER_CTA)
    c = torch.where(cu < H, 2 * H + cu, torch.full_like(cu, -1))
    return torch.cat([ur, c], dim=1).reshape(-1)


@functools.lru_cache(maxsize=None)
def _pack_index(H: int, device: torch.device):
    """The packed rows that hold a column of W, and those columns, on
    `device`: made once, so that pack_w copies nothing from the host and
    waits for nothing on the card."""
    cols = packed_columns(H)
    rows = torch.nonzero(cols >= 0).squeeze(1)
    return rows.to(device), cols[rows].to(device)


def pack_w(w):
    """W [H, 3H] in the bf16 forward's layout: [groups, 48, Hp] with
    packed[g, n, k] = W[k, packed_columns(H)[48·g + n]], zero where the
    unit or k is padding (Hp = padded_units(H))."""
    H = w.shape[0]
    Hp = padded_units(H)
    rows, cols = _pack_index(H, w.device)
    out = torch.zeros(3 * Hp, Hp, dtype=w.dtype, device=w.device)
    out[rows, :H] = w.t()[cols]
    return out.reshape(-1, PACKED_COLUMNS, Hp)


def unpack_gates(packed, H: int):
    """Pre-activations in the packed column order [..., groups·48] back to
    W's order [..., 3H] (the padding columns dropped)."""
    cols = packed_columns(H).to(packed.device)
    valid = cols >= 0
    out = packed.new_empty(*packed.shape[:-1], 3 * H)
    out[..., cols[valid]] = packed[..., valid]
    return out


def _lib(name="gru_fwd"):
    lib = cuda_build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        n_ptr = 6 if name == "gru_fwd" else 11
        n_int = 4 if name == "gru_fwd" else 5
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = getattr(lib, f"{name}_tc_plan")
        plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def tc_plan(name: str, B: int, H: int):
    """How the current card takes the bf16 kernel `name` ("gru_fwd" or
    "gru_bwd") at batch B and width H: CTAs an SM, batch groups, 32-row
    sub-tiles a group and whether W's slice is in shared memory."""
    lib = _lib(name)
    out = (ctypes.c_int * 4)()
    err = getattr(lib, f"{name}_tc_plan")(B, H, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}: no plan for B={B}, H={H}: "
                           f"{getattr(lib, f'{name}_error_string')(err).decode()}")
    return dict(per_sm=out[0], groups=out[1], tiles_per_group=out[2], w_smem=bool(out[3]))


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
    bf16 = dt == torch.bfloat16
    x = x.contiguous()
    w = w.to(dt)
    w = pack_w(w) if bf16 else w.contiguous()
    mask = mask.to(torch.float32).contiguous()
    # one zeroed workspace. f32: the h exchange [2, B, H], then rh [B, H];
    # bf16: the h and rh exchanges [2, B, Hp] each, u [B, Hp] f32 for a CTA
    # that walks several sub-tiles, then the batch groups' barrier counters
    if bf16:
        plane = B * padded_units(H)
        nbytes = 2 * 2 * plane * 2 + 4 * plane + 4 * -(-B // ROWS_PER_TILE)
    else:
        nbytes = 3 * B * H * 4
    with torch.cuda.device(x.device):
        lib = _lib()
        h_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
        h_T = torch.empty(B, H, dtype=dt, device=x.device)
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=x.device)
        err = lib.gru_fwd_launch(
            int(bf16), x.data_ptr(), mask.data_ptr(), w.data_ptr(), h_seq.data_ptr(),
            h_T.data_ptr(), ws.data_ptr(), T, B, H, int(bool(reverse)),
            torch.cuda.current_stream().cuda_stream)
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
    bf16 = dt == torch.bfloat16
    fuse_dw = H <= GRU_FUSED_DW_MAX_H
    args = [t.contiguous() for t in (ur_pre, c_pre, h_prev, rh, dh_seq)]
    mask = mask.to(torch.float32).contiguous()
    w, dhT = (pad_w_bwd(w) if bf16 else w.contiguous()), dhT.contiguous()
    # f32: scratch for dc_pre [B, H] and [du | dr] [B, 2H]; bf16: the zeroed
    # exchange [2, B, 3·Hp] (its padding columns stay zero), then the batch
    # groups' barrier counters
    if bf16:
        nbytes = 2 * B * 3 * padded_units(H) * 2 + 4 * -(-B // ROWS_PER_TILE)
    else:
        nbytes = 3 * B * H * 4
    with torch.cuda.device(h_prev.device):
        lib = _lib("gru_bwd")
        dx = torch.empty(T, B, 3 * H, dtype=dt, device=h_prev.device)
        dw = torch.empty(H, 3 * H, dtype=dt, device=h_prev.device)
        ws = (torch.zeros if bf16 else torch.empty)(nbytes, dtype=torch.uint8,
                                                    device=h_prev.device)
        err = lib.gru_bwd_launch(
            int(bf16), *(a.data_ptr() for a in args), mask.data_ptr(), w.data_ptr(),
            dhT.data_ptr(), dx.data_ptr(), dw.data_ptr(), ws.data_ptr(), T, B, H,
            int(bool(reverse)), int(fuse_dw), torch.cuda.current_stream().cuda_stream)
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
