"""Activation op kernels (paddle_tpu/ops/activation_ops.py), cut to the
activations the ported paths name: the `tanh` op, and the gate and
candidate activations `rnn_ops._act` looks up in `_ACTIVATIONS`."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op

# name -> fn(x, attrs), the JAX package's table signature
_ACTIVATIONS = {
    "identity": lambda x, a: x,
    "linear": lambda x, a: x,
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
}


def apply_activation(x, act: str, attrs=None):
    """Apply a named activation to a tensor or LoDArray."""
    try:
        fn = _ACTIVATIONS[act]
    except KeyError:
        raise NotImplementedError(
            f"activation {act!r} is not ported to the PyTorch port yet") from None
    if isinstance(x, LoDArray):
        return x.with_data(fn(x.data, attrs or {}))
    return fn(x, attrs or {})


def _make_kernel(name):
    def kernel(ctx):
        ctx.set_output("Out", apply_activation(ctx.input("X"), name, ctx.op.attrs))

    return kernel


for _name in _ACTIVATIONS:
    register_op(_name)(_make_kernel(_name))
