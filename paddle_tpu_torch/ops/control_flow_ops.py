"""The control-flow op kernels of paddle_tpu/ops/control_flow_ops.py:
`while_loop` (:19) and `cond` (:62), and the comparisons and logical ops
(:103-133): `less_than`, `less_equal`, `greater_than`, `greater_equal`,
`equal`, `not_equal`, `logical_and` and `logical_not`, elementwise with
numpy's broadcasting, a bool output that keeps X's LoD.

The JAX package traces the sub-blocks into `jax.lax.while_loop` and
`jax.lax.cond`, control flow inside one compiled program. An eager walk
must know on the host whether to run the body again or which branch to
take, so `while_loop` reads its condition once an iteration and `cond` its
predicate once. A CUDA graph cannot hold such a read: inside a capture
both raise `ControlFlowCaptureError`, and never run outside the graph
instead. `cond` runs only the branch taken, so the other branch's
parameters get exactly zero gradient. Reverse-mode differentiation
through `jax.lax.while_loop` raises in the JAX package; a While output that
reaches a loss here raises in the backward too (`_ForwardOnly`).
"""

from __future__ import annotations

import torch

from ..core import registry
from ..core.registry import register_op
from .generation_ops import step_env
from .math_ops import _data, _like


class ControlFlowCaptureError(RuntimeError):
    """A `while_loop` or `cond` op ran inside a CUDA graph capture: it
    reads its condition on the host, which a captured step cannot do."""


def _no_capture(op_type: str, t: torch.Tensor) -> None:
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise ControlFlowCaptureError(
            f"{op_type} reads its condition on the host, which a CUDA graph capture "
            f"cannot hold: run a program with {op_type} step by step (no scan_window)")


def _host_bool(op_type: str, x) -> bool:
    t = _data(x)
    _no_capture(op_type, t)
    return bool(t.reshape(()))


class _ForwardOnly(torch.autograd.Function):
    """The identity forward; the backward raises, as reverse mode through
    jax.lax.while_loop does."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "Reverse-mode differentiation does not work for while_loop: a While is "
            "forward-only, as jax.lax.while_loop is; build a trainable recurrence "
            "with recurrent_group")


@register_op("while_loop", runs_once=registry.sub_blocks_run_once)
def while_loop_kernel(ctx):
    """The sub-block while the carried condition holds, read on the host
    before each iteration: the entry values decide the first, the block's
    updates the next (while_op.cc). Zero iterations give the entry
    values."""
    carried_names = list(ctx.attr("carried"))
    update_names = list(ctx.attr("updates"))
    block = ctx.executor.program.blocks[ctx.attr("sub_block")]
    outer = step_env(ctx.env)
    cond_pos = carried_names.index(ctx.op.inputs["Cond"][0])
    vals = ctx.inputs("Carried")
    while _host_bool("while_loop", vals[cond_pos]):
        env = dict(outer)
        env.update(zip(carried_names, vals))
        ctx.executor.run_ops(block.ops, env, block)
        vals = [env[u] for u in update_names]
    for i, v in enumerate(vals):
        if isinstance(v, torch.Tensor) and v.requires_grad:
            v = _ForwardOnly.apply(v)
        ctx.set_output("Out", v, i)


@register_op("cond", runs_once=registry.sub_blocks_run_once)
def cond_kernel(ctx):
    """The branch the predicate (read on the host) picks, alone."""
    taken = "true" if _host_bool("cond", ctx.input("Pred")) else "false"
    block = ctx.executor.program.blocks[ctx.attr(f"{taken}_block")]
    env = step_env(ctx.env)
    ctx.executor.run_ops(block.ops, env, block)
    for i, name in enumerate(ctx.attr(f"{taken}_outs")):
        ctx.set_output("Out", env[name], i)


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
