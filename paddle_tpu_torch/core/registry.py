"""Op kernel registry.

A kernel is a plain function `kernel(ctx: OpContext) -> None` that reads
its inputs (torch tensors or LoDArrays) from `ctx`, computes eagerly on
their device, and assigns its outputs — the interface of
paddle_tpu/core/registry.py. Random ops draw from the run's
torch.Generator (`ctx.generator()`) where the JAX package splits a traced
key.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

_KERNELS: Dict[str, Callable] = {}
# op type -> whether an op of it takes an effect that must happen once a
# step (a draw from the run's generator, a site recorded on the tape):
# True, or a predicate on (op, env)
_RUNS_ONCE: Dict[str, Union[bool, Callable]] = {}

# env key of the run's torch.Generator, which the random ops draw from
RNG_KEY = "@RNG@"
# env key of a training run's SparseGradTape (core/sparse.py), present
# while its forward ops run when is_sparse tables take gradients
SPARSE_KEY = "@SPARSE_TAPE@"
# env key of the names a run reads after they are written (a later op's
# input, a fetch or a persistable); absent, every output counts as read
LIVE_KEY = "@LIVE@"
# env key present while a rematerialized segment's ops run (core/remat.py):
# its recompute would take a once-only effect a second time
REMAT_KEY = "@REMAT@"
# env key of the program a run executes, whose sub-blocks a control-flow
# op's `runs_once` rule reads (`sub_blocks_run_once`)
PROGRAM_KEY = "@PROGRAM@"
# the attrs naming the sub-blocks an op runs (recurrent groups, While, cond)
SUB_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


class OpContext:
    """Execution context handed to a kernel: op descriptor + value env, and
    the runner walking the op's block (`executor`), through which a
    control-flow kernel runs its sub-block (ops/generation_ops.py)."""

    def __init__(self, op, env: Dict[str, Any], executor=None):
        self.op = op
        self.env = env
        self.executor = executor

    def input(self, slot: str, idx: int = 0):
        names = self.op.inputs.get(slot, [])
        if not names:
            return None
        return self.env[names[idx]]

    def inputs(self, slot: str) -> List[Any]:
        return [self.env[n] for n in self.op.inputs.get(slot, [])]

    def has_input(self, slot: str) -> bool:
        return bool(self.op.inputs.get(slot))

    def set_output(self, slot: str, value, idx: int = 0) -> None:
        self.env[self.op.outputs[slot][idx]] = value

    def has_output(self, slot: str) -> bool:
        return bool(self.op.outputs.get(slot))

    def output_read(self, slot: str) -> bool:
        """Whether anything of the run reads this output. An eager run has
        no compiler to drop a dead output, as XLA drops it for the JAX
        package, so a kernel may skip computing one that nothing reads."""
        live = self.env.get(LIVE_KEY)
        names = self.op.outputs.get(slot, [])
        return bool(names) and (live is None or any(n in live for n in names))

    def attr(self, name: str, default=None):
        return self.op.attrs.get(name, default)

    def once(self) -> None:
        """Called by a kernel before an effect that must happen once a step
        (a draw, a tape record). Inside a rematerialized segment, which the
        backward runs again, it raises: the op's registration must declare
        `runs_once`, so that the segmenter runs it between segments."""
        if REMAT_KEY in self.env:
            raise RuntimeError(
                f"op {self.op.type!r} takes a once-only effect inside a rematerialized "
                f"segment, whose recompute would take it again: register it with "
                f"register_op({self.op.type!r}, runs_once=...)")

    def generator(self):
        """The run's random generator, on the executor's device: a draw
        (`once`)."""
        self.once()
        return self.env[RNG_KEY]

    def device(self):
        """The executor's device (the generator's), for an op that makes a
        tensor from nothing."""
        return self.env[RNG_KEY].device


def register_op(type_name: str, runs_once: Union[bool, Callable] = False) -> Callable:
    """Decorator: @register_op("mul") def mul_kernel(ctx): ...
    `runs_once`: True, or a predicate runs_once(op, env), for an op whose
    kernel takes an effect that must happen once a step (it calls
    `ctx.once()`, as `ctx.generator()` does)."""

    def deco(fn):
        if type_name in _KERNELS:
            raise ValueError(f"op {type_name!r} already registered")
        _KERNELS[type_name] = fn
        if runs_once:
            _RUNS_ONCE[type_name] = runs_once
        return fn

    return deco


def runs_once(op, env) -> bool:
    """Whether `op`, about to run on `env`, takes a once-only effect (its
    registration's `runs_once`)."""
    rule = _RUNS_ONCE.get(op.type, False)
    return rule if isinstance(rule, bool) else bool(rule(op, env))


def sub_blocks(op, program) -> list:
    """The blocks of `program` that `op` runs (none for a plain op)."""
    return [program.blocks[op.attrs[k]] for k in SUB_BLOCK_ATTRS if k in op.attrs]


def sub_blocks_run_once(op, env) -> bool:
    """The `runs_once` rule of an op that runs sub-blocks: whether any op of
    them, nested ones too, runs once (a dropout in a recurrent group's step
    draws from the generator). Without the program in the env, it does."""
    program = env.get(PROGRAM_KEY)
    if program is None:
        return True
    return any(runs_once(o, env) for b in sub_blocks(op, program) for o in b.ops)


def get_kernel(type_name: str) -> Callable:
    try:
        return _KERNELS[type_name]
    except KeyError:
        raise NotImplementedError(
            f"No kernel registered for op {type_name!r} in the PyTorch port; "
            f"registered: {sorted(_KERNELS)}"
        ) from None
