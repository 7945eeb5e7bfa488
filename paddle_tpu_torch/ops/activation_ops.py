"""Activation op kernels (paddle_tpu/ops/activation_ops.py), cut to the
activations the ported paths name: the `tanh` op, `fc`'s `gelu`, the gate,
cell and candidate activations `rnn_ops._act` looks up in `_ACTIVATIONS`,
and the `softmax` op over the last axis (:114)."""

from __future__ import annotations

import math

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op


def sigmoid(x):
    """jax.nn.sigmoid as the JAX package's programs compute it: lowered to
    1/(1+exp(-x)) op by op in x's dtype. In bf16 that rounds after each op,
    where torch.sigmoid rounds once, and the two differ in about a third of
    the values."""
    return 1 / (1 + torch.exp(-x))


def softmax(x, dim=-1):
    """jax.nn.softmax's own formula, exp(x - max) / sum, op by op in x's
    dtype, so bf16 rounds where the JAX package rounds; torch.softmax
    rounds once."""
    e = torch.exp(x - x.max(dim, keepdim=True).values)
    return e / e.sum(dim, keepdim=True)


def rounded(v: float, dtype) -> float:
    """The Python float v rounded to dtype, as JAX rounds a weakly typed
    constant before an op in that dtype. A Python number, not a tensor, so
    a CUDA op that takes it copies nothing to the card."""
    return float(torch.tensor(v, dtype=dtype))


def gelu(x):
    """jax.nn.gelu(approximate=True) as the JAX package computes it
    (paddle_tpu/ops/activation_ops.py:75): x·(0.5·(1 + tanh(c·(x +
    0.044715·x·(x·x))))), op by op in x's dtype, with the constants
    rounded to it first. In bf16 that rounds after each op, where
    F.gelu(approximate="tanh") rounds once."""
    c, k = rounded(math.sqrt(2 / math.pi), x.dtype), rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


# name -> fn(x, attrs), the JAX package's table signature
_ACTIVATIONS = {
    "identity": lambda x, a: x,
    "linear": lambda x, a: x,
    "relu": lambda x, a: torch.relu(x),
    "sigmoid": lambda x, a: sigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "gelu": lambda x, a: gelu(x),
    "softmax": lambda x, a: softmax(x),
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
