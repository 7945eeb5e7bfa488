"""Program IR: Program → Block → Operator / Variable.

The port's copy of paddle_tpu/core/program.py, cut to what a saved
program needs: the three-level structure, `set_amp`, and the
`to_dict`/`from_dict` schema (version 1), kept field for field so a
`program.json` written by the JAX package loads here unchanged and a
program loaded here serializes back to the same dict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


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

    def __repr__(self):
        return f"Var({self.name}, shape={self.shape}, lod={self.lod_level})"


@dataclass
class Operator:
    type: str
    inputs: Dict[str, List[str]]
    outputs: Dict[str, List[str]]
    attrs: Dict[str, Any] = field(default_factory=dict)

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

    def create_var(self, name, shape=(), dtype=np.float32, **kw) -> Variable:
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, tuple(shape), dtype, **kw)
        self.vars[name] = v
        return v


class Program:
    """Holds blocks; block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        # mixed-precision compute dtype (None = full f32); see amp.py
        self.amp_dtype: Optional[str] = None

    def set_amp(self, dtype: Optional[str] = "bfloat16") -> None:
        """Enable/disable bf16 activations for the program's runs."""
        self.amp_dtype = dtype

    def global_block(self) -> Block:
        return self.blocks[0]

    def persistables(self) -> List[Variable]:
        return [v for v in self.global_block().vars.values() if v.persistable]

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
                        {"type": op.type, "inputs": op.inputs,
                         "outputs": op.outputs, "attrs": op.attrs}
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
