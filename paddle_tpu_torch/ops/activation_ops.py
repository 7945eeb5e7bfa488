"""Activation op kernels (paddle_tpu/ops/activation_ops.py): every
activation of its `_ACTIVATIONS` table (:25-76), each an op of its own name
and an `act=` of any layer (`apply_activation`), with the reference's
attribute defaults; `softmax` over the last axis (:114) and
`softmax_activation` (:108-110). Each is the JAX function's formula in
x's dtype; the gradients come from autograd."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _soft_relu(x, t):
    """ln(1 + e^clip(x, -t, t)) (activation_op.cc SoftRelu)."""
    return torch.log1p(torch.exp(torch.clamp(x, -t, t)))


def _elu(x, alpha):
    """jax.nn.elu: x where x > 0, else alpha·expm1(x)."""
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(x > 0, _zero(x), x)))


# name -> fn(x, attrs), the JAX package's table signature and defaults
_ACTIVATIONS = {
    "identity": lambda x, a: x,
    "linear": lambda x, a: x,
    "sigmoid": lambda x, a: sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "exp": lambda x, a: torch.exp(x),
    "exponential": lambda x, a: torch.exp(x),
    "relu": lambda x, a: torch.relu(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "softshrink": lambda x, a: torch.sign(x) * torch.clamp_min(
        torch.abs(x) - a.get("lambda", 0.5), 0.0),
    "sqrt": lambda x, a: torch.sqrt(x),
    "abs": lambda x, a: torch.abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),  # half to even, as jnp.round
    "reciprocal": lambda x, a: 1.0 / x,
    "log": lambda x, a: torch.log(x),
    "square": lambda x, a: torch.square(x),
    "softplus": lambda x, a: torch.logaddexp(x, _zero(x)),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0), a.get("t_max", 24.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x, a.get("alpha", 0.02) * x),
    "soft_relu": lambda x, a: _soft_relu(x, a.get("threshold", 40.0)),
    "softrelu": lambda x, a: _soft_relu(x, 40.0),
    "elu": lambda x, a: _elu(x, a.get("alpha", 1.0)),
    "relu6": lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)),
    "pow": lambda x, a: torch.pow(x, a.get("factor", 1.0)),
    "stanh": lambda x, a: a.get("scale_a", 1.7159) * torch.tanh(a.get("scale_b", 2.0 / 3.0) * x),
    "hard_shrink": lambda x, a: torch.where(torch.abs(x) > a.get("threshold", 0.5), x, _zero(x)),
    "thresholded_relu": lambda x, a: torch.where(x > a.get("threshold", 1.0), x, _zero(x)),
    "hard_sigmoid": lambda x, a: torch.clamp(a.get("slope", 0.2) * x + a.get("offset", 0.5),
                                             0.0, 1.0),
    "swish": lambda x, a: x * sigmoid(a.get("beta", 1.0) * x),
    "gelu": lambda x, a: gelu(x),
    "softmax": lambda x, a: softmax(x),
}


def apply_activation(x, act: str, attrs=None):
    """Apply a named activation to a tensor or LoDArray (None: x)."""
    if act is None:
        return x
    try:
        fn = _ACTIVATIONS[act]
    except KeyError:
        raise NotImplementedError(f"unknown activation {act!r}") from None
    if isinstance(x, LoDArray):
        return x.with_data(fn(x.data, attrs or {}))
    return fn(x, attrs or {})


def _make_kernel(name):
    def kernel(ctx):
        ctx.set_output("Out", apply_activation(ctx.input("X"), name, ctx.op.attrs))

    return kernel


for _name in _ACTIVATIONS:
    register_op(_name)(_make_kernel(_name))
register_op("softmax_activation")(_make_kernel("softmax"))
