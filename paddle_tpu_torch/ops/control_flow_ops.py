"""The comparison and logical op kernels of paddle_tpu/ops/control_flow_ops.py
(:103-133): `less_than`, `less_equal`, `greater_than`, `greater_equal`,
`equal`, `not_equal`, `logical_and` and `logical_not`, elementwise with
numpy's broadcasting, a bool output that keeps X's LoD. The loops
(`while_loop`, `cond`) are not ported."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .math_ops import _data, _like


def _binary(name, fn):
    def kernel(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", _like(x, fn(_data(x), _data(ctx.input("Y")))))

    register_op(name)(kernel)


_binary("less_than", torch.lt)
_binary("less_equal", torch.le)
_binary("greater_than", torch.gt)
_binary("greater_equal", torch.ge)
_binary("equal", torch.eq)
_binary("not_equal", torch.ne)
_binary("logical_and", torch.logical_and)


@register_op("logical_not")
def logical_not_kernel(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", _like(x, torch.logical_not(_data(x))))
