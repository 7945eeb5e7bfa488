"""Program IR: Program → Block → Operator / Variable.

The port's copy of paddle_tpu/core/program.py, cut to what a saved
program and the layer DSL need: the three-level structure with sub-blocks
(`block_guard`), `set_amp`,
`version`/`bump_version`, `clone(for_test)`,
parameters with their regularizer, clip, learning-rate multiplier, update
hooks and trainable flag, the default
programs and `program_guard`, `unique_name` with the JAX package's counter
and names, and the `to_dict`/`from_dict` schema (version 1), kept field
for field so a `program.json` written by the JAX package loads here
unchanged, a program loaded here serializes back to the same dict, and a
program built here by the layer DSL serializes to the dict the JAX
package's DSL gives.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

_unique_counter = itertools.count()


def unique_name(prefix: str) -> str:
    return f"{prefix}_{next(_unique_counter)}"


def reset_unique_name() -> None:
    global _unique_counter
    _unique_counter = itertools.count()


def grad_var_name(name: str) -> str:
    """The gradient variable of `name`: `name@GRAD`."""
    return name + "@GRAD"


@dataclass
class Variable:
    """Symbolic tensor in a Block. shape uses -1 for the batch dimension;
    lod_level > 0 marks ragged inputs (a LoDArray at run time)."""

    block: "Block"
    name: str
    shape: tuple
    dtype: Any = np.float32
    lod_level: int = 0
    persistable: bool = False
    is_parameter: bool = False
    sparse_format: Optional[str] = None
    sparse_update: bool = False
    trainable: bool = True
    # regularization / clipping attributes (set from a ParamAttr)
    regularizer: Any = None
    grad_clip: Any = None
    # the learning-rate multiplier and the update hooks (set from a
    # ParamAttr); not part of to_dict, as the JAX package's
    optimize_attr: Dict[str, Any] = field(default_factory=lambda: {"learning_rate": 1.0})
    update_hooks: Optional[List[Any]] = None

    def __repr__(self):
        return f"Var({self.name}, shape={self.shape}, lod={self.lod_level})"


@dataclass
class Operator:
    type: str
    inputs: Dict[str, List[str]]
    outputs: Dict[str, List[str]]
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"


class Block:
    """Straight-line op list + symbol table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.ops: List[Operator] = []
        self.vars: Dict[str, Variable] = {}

    def create_var(self, name=None, shape=(), dtype=np.float32, **kw) -> Variable:
        name = name or unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, tuple(shape), dtype, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype=np.float32, **kw) -> Variable:
        v = self.create_var(name, shape, dtype, persistable=True, is_parameter=True, **kw)
        self.program.global_block().vars.setdefault(name, v)
        return v

    def var(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = self.program.blocks[b.parent_idx] if b.parent_idx >= 0 else None
        raise KeyError(f"Variable {name!r} not found in block {self.idx}")

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> "Operator":
        """Variables (or names) per slot, a single one or a list."""
        def norm(d):
            return {k: [x.name if isinstance(x, Variable) else x
                        for x in (v if isinstance(v, (list, tuple)) else [v])]
                    for k, v in (d or {}).items()}

        op = Operator(type, norm(inputs), norm(outputs), dict(attrs or {}))
        self.ops.append(op)
        self.program.bump_version()
        return op


class Program:
    """Holds blocks; block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0
        # mixed-precision compute dtype (None = full f32); see amp.py
        self.amp_dtype: Optional[str] = None
        # the random ops' seed for runs given none (0 = a fresh seed each
        # run), as the JAX package's; not part of to_dict
        self.random_seed: int = 0
        # the backward's rematerialization policy (core/executor.py
        # memory_optimize; None: the forward's values are kept); not part of
        # to_dict, as the JAX package's
        self.remat_policy: Optional[str] = None

    def set_amp(self, dtype: Optional[str] = "bfloat16") -> None:
        """Enable/disable bf16 activations for the program's runs."""
        self.amp_dtype = dtype

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self) -> Block:
        b = Block(self, len(self.blocks), parent_idx=self._current_block_idx)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self) -> None:
        self._current_block_idx = self.current_block().parent_idx

    @contextlib.contextmanager
    def block_guard(self):
        """Layers built inside append to a new sub-block (a generation
        step's body, layers/generation.py)."""
        b = self.create_block()
        try:
            yield b
        finally:
            self.rollback()

    def parameters(self) -> List[Variable]:
        return [v for v in self.global_block().vars.values() if v.is_parameter]

    def persistables(self) -> List[Variable]:
        return [v for v in self.global_block().vars.values() if v.persistable]

    def bump_version(self) -> None:
        self._version += 1

    @property
    def version(self) -> int:
        """Counts edits (ops appended, a quantization rewrite); not part of
        to_dict, so a saved program and its reloaded self serialize alike."""
        return self._version

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy; for_test=True also drops the backward and optimizer
        ops and sets every `is_test` attr."""
        p = copy.deepcopy(self)
        if for_test:
            for b in p.blocks:
                b.ops = [op for op in b.ops
                         if op.type != "autodiff" and not op.attrs.get("is_optimizer_op")]
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
            p.bump_version()
        return p

    # -- serialization: the schema of paddle_tpu Program.to_dict ------------
    def to_dict(self) -> dict:
        def var_d(v: Variable):
            d = {
                "name": v.name,
                "shape": list(v.shape),
                "dtype": np.dtype(v.dtype).name,
                "lod_level": v.lod_level,
                "persistable": v.persistable,
                "is_parameter": v.is_parameter,
            }
            if v.sparse_update:
                d["sparse_update"] = True
            if v.sparse_format:
                d["sparse_format"] = v.sparse_format
            return d

        return {
            "version": 1,
            "blocks": [
                {
                    "idx": b.idx,
                    "parent_idx": b.parent_idx,
                    "vars": [var_d(v) for v in b.vars.values()],
                    "ops": [
                        {"type": op.type, "inputs": op.inputs, "outputs": op.outputs,
                         "attrs": {k: v for k, v in op.attrs.items() if _json_safe(v)}}
                        for op in b.ops
                    ],
                }
                for b in self.blocks
            ],
        }

    @staticmethod
    def from_dict(d: dict) -> "Program":
        if d.get("version") != 1:
            raise ValueError(f"unsupported program schema version {d.get('version')!r}")
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                b.create_var(
                    vd["name"],
                    tuple(vd["shape"]),
                    np.dtype(vd["dtype"]),
                    lod_level=vd["lod_level"],
                    persistable=vd["persistable"],
                    is_parameter=vd["is_parameter"],
                    sparse_update=vd.get("sparse_update", False),
                    sparse_format=vd.get("sparse_format"),
                )
            for od in bd["ops"]:
                b.ops.append(Operator(od["type"], od["inputs"], od["outputs"], od["attrs"]))
            p.blocks.append(b)
        return p


def _json_safe(v) -> bool:
    """What to_dict keeps of an op's attrs, as the JAX package does."""
    if isinstance(v, (bool, int, float, str, type(None))):
        return True
    if isinstance(v, (list, tuple)):
        return all(_json_safe(x) for x in v)
    return False


# -- the default programs the layer DSL appends to ---------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main: Program, startup: Optional[Program] = None):
    """Layers built inside append to `main` (and their initializers to
    `startup`)."""
    global _main_program, _startup_program
    old_m, old_s = _main_program, _startup_program
    _main_program = main
    if startup is not None:
        _startup_program = startup
    try:
        yield
    finally:
        _main_program, _startup_program = old_m, old_s


def reset_default_programs():
    """Fresh default programs and unique-name counter."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    reset_unique_name()
