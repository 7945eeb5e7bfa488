"""Automatic mixed precision: bf16 activations, f32 master weights.

The policy of paddle_tpu/amp.py: parameters stay float32; the inputs of
"low" ops are cast to the amp dtype and their outputs stay in it, so
activations flow at 2 bytes/element; where an f32 master meets an amp
activation in an elementwise op, the f32 side casts DOWN (`harmonize`).
The executor puts the program's amp dtype into the env under `@AMP@`.
"""

from __future__ import annotations

import torch

AMP_KEY = "@AMP@"

# matrix-unit ops whose kernels call cast_inputs: inputs drop to the amp dtype
LOW_PRECISION_OPS = frozenset({
    "mul", "matmul", "conv2d", "conv2d_transpose", "fused_conv_bn",
    "flash_attention", "lookup_table",
})

# the low-precision sites the int8 converter may rewrite (quant/convert.py):
# dense weight-carrying GEMMs with a quantized op (ops/quant_kernels.py)
QUANTIZABLE_OPS = frozenset({"mul", "matmul"})

# numerically sensitive: upcast internally, emit f32
HIGH_PRECISION_OPS = frozenset({
    "batch_norm", "layer_norm", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "mean",
    "reduce_mean", "huber_loss", "smooth_l1", "squared_l2_norm",
    "l2_normalize", "exp", "log",
})

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32}


def precision_policy(op_type: str) -> str:
    """'low' | 'high' | 'follow' for one op type (see the tables above)."""
    if op_type in HIGH_PRECISION_OPS:
        return "high"
    if op_type in LOW_PRECISION_OPS:
        return "low"
    return "follow"


def amp_dtype(ctx):
    """The torch dtype of the program's amp setting, or None."""
    name = ctx.env.get(AMP_KEY)
    return None if name is None else _TORCH_DTYPES[name]


def cast_inputs(ctx, *arrays):
    """Cast float32 tensors to the program's amp dtype (no-op otherwise,
    and always a no-op for an op on the high-precision list)."""
    dtype = amp_dtype(ctx)
    if dtype is not None and precision_policy(ctx.op.type) == "high":
        dtype = None
    out = [a.to(dtype) if dtype is not None and a.dtype == torch.float32 else a
           for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)


def harmonize(ctx, x, y):
    """Binary elementwise meeting rule under amp: an f32 operand meeting an
    amp-dtype operand is cast down, not the other way round."""
    dtype = amp_dtype(ctx)
    if dtype is None:
        return x, y
    if x.dtype == dtype and y.dtype == torch.float32:
        y = y.to(dtype)
    elif y.dtype == dtype and x.dtype == torch.float32:
        x = x.to(dtype)
    return x, y
