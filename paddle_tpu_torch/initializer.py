"""Parameter initializers (paddle_tpu/initializer.py): each appends the
startup op that fills a parameter (fill_constant, uniform_random,
gaussian_random) to the startup program's global block, with the JAX
package's attributes, so a program built here serializes to the same
dict and the port's startup ops run it."""

from __future__ import annotations

import math

import numpy as np

from .core.program import Program, Variable, default_startup_program


class Initializer:
    def __call__(self, var: Variable, startup: Program = None):
        raise NotImplementedError


def _append(startup, var, op_type, attrs):
    b = (startup or default_startup_program()).global_block()
    b.create_var(var.name, var.shape, var.dtype, persistable=True)
    b.append_op(op_type, outputs={"Out": [var.name]},
                attrs={"shape": list(var.shape), **attrs, "dtype": np.dtype(var.dtype).name})


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, startup=None):
        _append(startup, var, "fill_constant", {"value": self.value})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, startup=None):
        _append(startup, var, "uniform_random", {"min": self.low, "max": self.high})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, startup=None):
        _append(startup, var, "gaussian_random", {"mean": self.loc, "std": self.scale})


def _fan_in_out(var: Variable):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    recept = int(np.prod(shape[2:]))
    return shape[1] * recept, shape[0] * recept


class XavierInitializer(Initializer):
    """Glorot: uniform in ±sqrt(6 / (fan_in + fan_out)), or normal."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, var, startup=None):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit)(var, startup)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / (fi + fo)))(var, startup)


class MSRAInitializer(Initializer):
    """He: uniform in ±sqrt(6 / fan_in), or normal."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, var, startup=None):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in or fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit)(var, startup)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi))(var, startup)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
