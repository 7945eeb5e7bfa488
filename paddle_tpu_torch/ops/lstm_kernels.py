"""LSTM over a whole sequence, forward and backward: the hand-written
Hopper kernels (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu), their plain PyTorch
versions, and `lstm_fused`, the autograd Function over the two.

Replaces the TPU kernels `_lstm_kernel` / `_lstm_pallas_raw` and
`_lstm_bwd_kernel` / `_lstm_bwd_pallas` (paddle_tpu/ops/pallas_kernels.py:
155-389) and `lstm_fused` / `_lstm_core` (:391-453). Gate layout in the 4H
columns: [i, f, g (candidate), o]. Both kernels are bound by their T
dependent steps, not by bytes or FLOPs: each step needs all of the previous
step's h (or the dgates of every unit), so CTAs meet at a barrier once a
step, and the per-step exchange stays in L2 (see the sources' notes).

The bf16 forward runs its product on the tensor cores, a CTA owning
UNITS_PER_CTA hidden units of a group of batch rows, with a barrier among
the group's CTAs only. Its W slice is read in the packed layout `pack_w`
makes: for each group of 16 units, 64 gate columns ordered so that one
thread's mma.sync accumulator fragment holds i, f, g and o of one unit
(`packed_columns`), each stored K-contiguous (Wᵀ), H padded to a multiple
of 16 with zeros. The bf16 backward, on the same partition (16 units a
CTA, batch groups of 32-row tiles, a barrier a group), reads W padded by
`pad_w_bwd` and takes dW off the recurrence: a second kernel behind the
same launch computes it as one product over all T·B rows. The f32 kernels
read W as it is.

`lstm_fwd` and `lstm_bwd` take CUDA tensors to the kernel, or raise; CPU
tensors to the plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

# launches of the CUDA kernels in this process; chip_smoke.py reads them
lstm_fwd_launches = 0
lstm_bwd_launches = 0

# above this H the backward leaves dW to a batched product outside the
# kernel, as _lstm_bwd_pallas does (_LSTM_FUSED_DW_MAX_H, pallas_kernels.py:329)
LSTM_FUSED_DW_MAX_H = 640

_IO_DTYPES = (torch.float32, torch.bfloat16)

# kUnits and kRows in csrc/lstm_fwd.cu and csrc/lstm_bwd.cu: the bf16
# kernels' hidden units a CTA and batch rows a sub-tile
UNITS_PER_CTA = 16
ROWS_PER_TILE = 32


def _gates(gates):
    """i, f, g, o of f32 pre-activations [B, 4H]."""
    H = gates.shape[-1] // 4
    return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))


def lstm_fwd_plain(x, mask, w, reverse: bool = False):
    """The function `_lstm_kernel` computes, step by step on any device.

    x [T,B,4H] io dtype with the bias already added, mask [T,B], w [H,4H]
    (cast to the io dtype). The gates are x + h@W in f32, the product not
    rounded; h and c are carried, masked, in the io dtype.
    Returns (h_seq, c_seq [T,B,H], h_T, c_T [B,H]) in the io dtype."""
    T, B, H4 = x.shape
    H = H4 // 4
    dt = x.dtype
    wf = w.to(dt).float()
    mf = mask.float()
    h = torch.zeros(B, H, dtype=dt, device=x.device)
    c = torch.zeros(B, H, dtype=dt, device=x.device)
    h_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
    c_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hf, cf = h.float(), c.float()
        i, f, g, o = _gates(x[t].float() + hf @ wf)
        cn = f * cf + i * g
        hn = o * torch.tanh(cn)
        m = mf[t][:, None]
        h = (m * hn + (1 - m) * hf).to(dt)
        c = (m * cn + (1 - m) * cf).to(dt)
        h_seq[t], c_seq[t] = h, c
    return h_seq, c_seq, h, c


def padded_units(H: int) -> int:
    """H rounded up to whole groups of UNITS_PER_CTA (the bf16 forward's
    Hp: the packed W's k extent and the h exchange buffer's row)."""
    return -(-H // UNITS_PER_CTA) * UNITS_PER_CTA


def packed_columns(H: int):
    """The bf16 forward's packed gate-column order: for packed column
    (group, n), n < 4·UNITS_PER_CTA, the column of W [H, 4H] it holds, or
    -1 where its unit is padding. Within a group, warp quad uq's 16
    columns hold units 4·uq + r (r < 4) as n = 16·uq + 8·(gate // 2) +
    2·r + gate % 2, so mma.sync's accumulator lane r holds i, f (first
    n-tile) and g, o (second) of one unit. Returns a [groups·64] long
    tensor."""
    groups = padded_units(H) // UNITS_PER_CTA
    # axes: group, uq, gate // 2, r, gate % 2 (the packed order, n fastest last)
    grp, uq, gh, r, gl = torch.meshgrid(
        torch.arange(groups), torch.arange(UNITS_PER_CTA // 4), torch.arange(2),
        torch.arange(4), torch.arange(2), indexing="ij")
    unit = grp * UNITS_PER_CTA + uq * 4 + r
    col = torch.where(unit < H, (2 * gh + gl) * H + unit, torch.full_like(unit, -1))
    return col.reshape(-1)


@functools.lru_cache(maxsize=None)
def _pack_index(H: int, device: torch.device):
    """The packed rows that hold a column of W, and those columns, on
    `device`: made once, so that pack_w copies nothing from the host and
    waits for nothing on the card (a step that packs W can be captured in a
    CUDA graph)."""
    cols = packed_columns(H)
    rows = torch.nonzero(cols >= 0).squeeze(1)
    return rows.to(device), cols[rows].to(device)


def pack_w(w):
    """W [H, 4H] in the bf16 forward's layout: [groups, 64, Hp] with
    packed[g, n, k] = W[k, packed_columns(H)[64·g + n]], zero where the
    unit or k is padding (Hp = padded_units(H))."""
    H = w.shape[0]
    Hp = padded_units(H)
    rows, cols = _pack_index(H, w.device)
    out = torch.zeros(4 * Hp, Hp, dtype=w.dtype, device=w.device)
    out[rows, :H] = w.t()[cols]
    return out.reshape(-1, 4 * UNITS_PER_CTA, Hp)


def unpack_gates(packed, H: int):
    """Gate pre-activations in the packed column order [..., groups·64]
    back to W's order [..., 4H] (the padding columns dropped)."""
    cols = packed_columns(H).to(packed.device)
    valid = cols >= 0
    out = packed.new_empty(*packed.shape[:-1], 4 * H)
    out[..., cols[valid]] = packed[..., valid]
    return out


def pad_w_bwd(w):
    """W [H, G·H] (G gates: 4 for the LSTM, 3 for the GRU) as the bf16
    backward kernels read it: [Hp, G·Hp] with row j the weights of unit j
    and gate q's columns at q·Hp (Hp = padded_units(H)), zero where the unit
    or k is padding, as the exchanged gate gradients are laid out. Row j is
    the K-contiguous B operand of unit j's products: nothing is
    transposed."""
    H = w.shape[0]
    G = w.shape[1] // H
    Hp = padded_units(H)
    out = torch.zeros(Hp, G, Hp, dtype=w.dtype, device=w.device)
    out[:H, :, :H] = w.reshape(H, G, H)
    return out.reshape(Hp, G * Hp)


def _lib(name):
    lib = cuda_build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        n_ptr = 9 if name == "lstm_fwd" else 12
        n_int = 4 if name == "lstm_fwd" else 5
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _check_same(fn, ref_name, ref, named):
    """Every named tensor on ref's device, in ref's dtype unless it is the
    mask; raises on the first that is not."""
    for name, t in named:
        if t.device != ref.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, {ref_name} on {ref.device}")
        if name != "mask" and t.dtype != ref.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, {ref_name} {ref.dtype}")


def _check_fwd(x, mask, w):
    if x.dim() != 3 or x.shape[2] % 4:
        raise ValueError(f"lstm_fwd: x must be [T,B,4H], got {tuple(x.shape)}")
    T, B, H4 = x.shape
    H = H4 // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"lstm_fwd: empty input {tuple(x.shape)}")
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"lstm_fwd: io dtype must be float32 or bfloat16, got {x.dtype}")
    if tuple(w.shape) != (H, H4):
        raise ValueError(f"lstm_fwd: w must be [{H},{H4}], got {tuple(w.shape)}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"lstm_fwd: mask must be [{T},{B}], got {tuple(mask.shape)}")
    for name, t in (("mask", mask), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"lstm_fwd: {name} is on {t.device}, x on {x.device}")


def lstm_fwd(x, mask, w, reverse: bool = False):
    """Whole-sequence masked LSTM forward; see lstm_fwd_plain for the
    contract. CUDA tensors launch the sm_90a kernel; CPU tensors run the
    plain version."""
    global lstm_fwd_launches
    _check_fwd(x, mask, w)
    if x.device.type == "cpu":
        return lstm_fwd_plain(x, mask, w, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_fwd: unsupported device {x.device}")
    T, B, H4 = x.shape
    H = H4 // 4
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    x = x.contiguous()
    w = w.to(dt)
    w = pack_w(w) if bf16 else w.contiguous()
    mask = mask.to(torch.float32).contiguous()
    # one zeroed workspace: the two h exchange buffers [2, B, Hp], then
    # (bf16) the batch groups' barrier counters, at most one a row tile
    hp = padded_units(H) if bf16 else H
    h_bytes = 2 * B * hp * x.element_size()
    n_bars = -(-B // ROWS_PER_TILE) if bf16 else 0
    with torch.cuda.device(x.device):
        lib = _lib("lstm_fwd")
        h_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
        c_seq = torch.empty(T, B, H, dtype=dt, device=x.device)
        h_T = torch.empty(B, H, dtype=dt, device=x.device)
        c_T = torch.empty(B, H, dtype=dt, device=x.device)
        ws = torch.zeros(h_bytes + 4 * n_bars, dtype=torch.uint8, device=x.device)
        err = lib.lstm_fwd_launch(
            int(bf16), x.data_ptr(), mask.data_ptr(), w.data_ptr(),
            h_seq.data_ptr(), c_seq.data_ptr(), h_T.data_ptr(), c_T.data_ptr(),
            ws.data_ptr(), ws.data_ptr() + h_bytes if bf16 else None, T, B, H,
            int(bool(reverse)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_fwd kernel launch failed (T={T}, B={B}, H={H}, {dt}): "
            f"{lib.lstm_fwd_error_string(err).decode()}")
    lstm_fwd_launches += 1
    return h_seq, c_seq, h_T, c_T


# ------------------------------------------------------------- backward --
def lstm_bwd_inputs(x, w, h_seq, c_seq, reverse: bool = False):
    """The batched recompute (no recurrence) the backward kernel reads, as
    _lstm_bwd_pallas does it (pallas_kernels.py:336-343): h_prev and c_prev
    (the state each step started from; for `reverse` the one after it in
    time) and gates_pre = x + io(h_prev @ W), the product accumulated in
    f32 and rounded to the io dtype before the add, so in bf16 the backward
    sees slightly other gates than the forward used (as the TPU kernel's
    does). x is [T,B,4H] with the bias added, w [H,4H] in x's dtype."""
    zeros = torch.zeros_like(h_seq[:1])

    def shift(seq):
        return torch.cat([seq[1:], zeros] if reverse else [zeros, seq[:-1]])

    h_prev, c_prev = shift(h_seq), shift(c_seq)
    gates_pre = x + torch.matmul(h_prev, w)
    return gates_pre, c_prev, h_prev


def _dw_outside(h_prev, dx):
    """dW as _lstm_bwd_pallas computes it past LSTM_FUSED_DW_MAX_H: one
    batched product of the saved h_prev and dx (f32 accumulation, one
    rounding)."""
    T, B, H = h_prev.shape
    return torch.matmul(h_prev.reshape(T * B, H).T, dx.reshape(T * B, 4 * H))


def lstm_bwd_plain(gates_pre, c_prev, h_prev, dh_seq, mask, w, dhT, dcT,
                   reverse: bool = False):
    """The function `_lstm_bwd_kernel` computes, step by step on any device.

    All tensors but mask [T,B] are in the io dtype: gates_pre [T,B,4H],
    c_prev, h_prev and dh_seq [T,B,H], w [H,4H], dhT and dcT [B,H]. Walks t
    from T-1 down to 0 (from 0 up for `reverse`). Gate math in f32; the
    dgates are rounded to the io dtype before both products, the dh and dc
    carries each step, and dW, accumulated in f32, once at the end.
    Returns (dx [T,B,4H], dW [H,4H]) in the io dtype."""
    T, B, H = h_prev.shape
    dt = h_prev.dtype
    wf = w.to(dt).float()
    mf = mask.float()
    fuse_dw = H <= LSTM_FUSED_DW_MAX_H
    dw = torch.zeros(H, 4 * H, dtype=torch.float32, device=h_prev.device)
    dx = torch.empty(T, B, 4 * H, dtype=dt, device=h_prev.device)
    dh, dc = dhT.to(dt), dcT.to(dt)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = _gates(gates_pre[t].float())
        cp = c_prev[t].float()
        m = mf[t][:, None]
        tc = torch.tanh(f * cp + i * g)
        dh_total = dh_seq[t].float() + dh.float()
        dc_total = dc.float()
        dh_raw = m * dh_total
        dc_raw = m * dc_total + dh_raw * o * (1 - tc * tc)
        dgates = torch.cat([dc_raw * g * i * (1 - i), dc_raw * cp * f * (1 - f),
                            dc_raw * i * (1 - g * g), dh_raw * tc * o * (1 - o)], dim=1)
        dq = dgates.to(dt)
        dx[t] = dq
        dh = (dq.float() @ wf.T + (1 - m) * dh_total).to(dt)
        dc = (dc_raw * f + (1 - m) * dc_total).to(dt)
        if fuse_dw:
            dw += h_prev[t].float().T @ dq.float()
    if not fuse_dw:
        return dx, _dw_outside(h_prev, dx)
    return dx, dw.to(dt)


def _check_bwd(gates_pre, c_prev, h_prev, dh_seq, mask, w, dhT, dcT):
    if h_prev.dim() != 3:
        raise ValueError(f"lstm_bwd: h_prev must be [T,B,H], got {tuple(h_prev.shape)}")
    T, B, H = h_prev.shape
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"lstm_bwd: empty input {tuple(h_prev.shape)}")
    if h_prev.dtype not in _IO_DTYPES:
        raise TypeError(f"lstm_bwd: io dtype must be float32 or bfloat16, got {h_prev.dtype}")
    named = (("gates_pre", gates_pre), ("c_prev", c_prev), ("dh_seq", dh_seq),
             ("w", w), ("dhT", dhT), ("dcT", dcT))
    want = {"gates_pre": (T, B, 4 * H), "c_prev": (T, B, H), "dh_seq": (T, B, H),
            "w": (H, 4 * H), "dhT": (B, H), "dcT": (B, H)}
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"lstm_bwd: {name} must be {list(want[name])}, "
                             f"got {list(t.shape)}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"lstm_bwd: mask must be [{T},{B}], got {tuple(mask.shape)}")
    _check_same("lstm_bwd", "h_prev", h_prev, named + (("mask", mask),))


def lstm_bwd(gates_pre, c_prev, h_prev, dh_seq, mask, w, dhT, dcT, reverse: bool = False):
    """Reverse-time masked LSTM backward; see lstm_bwd_plain for the
    contract. CUDA tensors launch the sm_90a kernel; CPU tensors run the
    plain version."""
    global lstm_bwd_launches
    _check_bwd(gates_pre, c_prev, h_prev, dh_seq, mask, w, dhT, dcT)
    if h_prev.device.type == "cpu":
        return lstm_bwd_plain(gates_pre, c_prev, h_prev, dh_seq, mask, w, dhT, dcT, reverse)
    if h_prev.device.type != "cuda":
        raise ValueError(f"lstm_bwd: unsupported device {h_prev.device}")
    T, B, H = h_prev.shape
    dt = h_prev.dtype
    bf16 = dt == torch.bfloat16
    fuse_dw = H <= LSTM_FUSED_DW_MAX_H
    args = [t.contiguous() for t in (gates_pre, c_prev, h_prev, dh_seq, w, dhT, dcT)]
    if bf16:
        args[4] = pad_w_bwd(args[4])
    mask = mask.to(torch.float32).contiguous()
    # the two dgates exchange buffers [2, B, 4·Hp] (bf16: zeroed, the
    # padding columns stay zero), then (bf16) the batch groups' barrier
    # counters, at most one a row tile
    hp = padded_units(H) if bf16 else H
    dg_bytes = 2 * B * 4 * hp * h_prev.element_size()
    n_bars = -(-B // ROWS_PER_TILE) if bf16 else 0
    with torch.cuda.device(h_prev.device):
        lib = _lib("lstm_bwd")
        dx = torch.empty(T, B, 4 * H, dtype=dt, device=h_prev.device)
        dw = torch.empty(H, 4 * H, dtype=dt, device=h_prev.device)
        ws = (torch.zeros if bf16 else torch.empty)(dg_bytes + 4 * n_bars, dtype=torch.uint8,
                                                    device=h_prev.device)
        err = lib.lstm_bwd_launch(
            int(bf16), *(a.data_ptr() for a in args[:4]), mask.data_ptr(),
            *(a.data_ptr() for a in args[4:]), dx.data_ptr(), dw.data_ptr(),
            ws.data_ptr(), ws.data_ptr() + dg_bytes if bf16 else None, T, B, H,
            int(bool(reverse)), int(fuse_dw), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_bwd kernel launch failed (T={T}, B={B}, H={H}, {dt}): "
            f"{lib.lstm_bwd_error_string(err).decode()}")
    lstm_bwd_launches += 1
    if not fuse_dw:
        dw = _dw_outside(args[2], dx)
    return dx, dw


class _LstmFn(torch.autograd.Function):
    """The counterpart of `_lstm_core` (pallas_kernels.py:425-453): the
    forward kernel, and a backward that recomputes the gate
    pre-activations in one batched product and runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, mask, w, reverse):
        h_seq, c_seq, h_T, c_T = lstm_fwd(x, mask, w, reverse=reverse)
        ctx.save_for_backward(x, mask, w, h_seq, c_seq)
        ctx.reverse = reverse
        return h_seq, h_T, c_T

    @staticmethod
    def backward(ctx, dh_seq, dhT, dcT):
        x, mask, w, h_seq, c_seq = ctx.saved_tensors
        gates_pre, c_prev, h_prev = lstm_bwd_inputs(x, w, h_seq, c_seq, ctx.reverse)
        dt = x.dtype
        dx, dw = lstm_bwd(gates_pre, c_prev, h_prev, dh_seq.to(dt), mask, w,
                          dhT.to(dt), dcT.to(dt), reverse=ctx.reverse)
        return dx, None, dw, None


def lstm_fused(x, mask, w, bias=None, reverse: bool = False):
    """Differentiable whole-sequence LSTM (zero initial state,
    sigmoid/tanh, no peepholes): the bias joins x in the io dtype and w is
    cast to it before the kernels, as lstm_fused does
    (pallas_kernels.py:391-422), so the bias's gradient is autograd's sum
    of dx. Returns (h_seq [T,B,H], (h_T, c_T) [B,H])."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    h_seq, h_T, c_T = _LstmFn.apply(x, mask, w.to(x.dtype), bool(reverse))
    return h_seq, (h_T, c_T)
