"""recurrent_group / StaticRNN / NestedRecurrentGroup
(paddle_tpu/layers/recurrent.py): a per-timestep sub-network over ragged
sequence inputs, the Gen-1 `recurrent_group` DSL with `memory()` boots and
links, and the Fluid `StaticRNN`.

The step is built as a sub-block of the program; the `recurrent_group`
op (ops/recurrent_ops.py) runs it once a frame. Values of the enclosing
block (parameters, projected encoder states) are usable inside the step
as they are; `static_input` is the identity, kept for the reference's
API."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np

from ..core.program import Variable, unique_name
from .helper import LayerHelper

__all__ = ["RecurrentGroup", "StaticRNN", "recurrent_group", "NestedRecurrentGroup"]


class _Memory:
    def __init__(self, inner: Variable, boot: Optional[Variable], shape, init_value):
        self.inner = inner
        self.boot = boot
        self.shape = tuple(shape or ())
        self.init_value = float(init_value)
        self.update: Optional[Variable] = None


class RecurrentGroup:
    """A per-timestep sub-network over ragged sequences::

        rnn = ptt.layers.RecurrentGroup()
        with rnn.step():
            x_t = rnn.step_input(seq)            # [B, D], step t's slice
            h_prev = rnn.memory(shape=[H])       # carried, booted at 0
            h = ptt.layers.fc(ptt.layers.concat([x_t, h_prev], axis=1),
                              size=H, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out_seq = rnn()                          # the sequence of h

    A memory boots from a dense [B, ...] variable with
    `rnn.memory(init=var)`. `max_len` bounds the frames run (default: the
    input's capacity, which never cuts); a sequence longer than it is cut:
    its later frames do not run, their outputs stay zero, and its final
    memory is the state at frame max_len."""

    BEFORE, IN, AFTER = 0, 1, 2
    op_type = "recurrent_group"

    def __init__(self, is_reverse: bool = False, max_len: Optional[int] = None, name=None):
        self.helper = LayerHelper("recurrent_group", name=name)
        self.is_reverse = is_reverse
        self.max_len = max_len
        self._status = self.BEFORE
        self._block = None
        self._seq_pairs: List[Tuple] = []  # (outer, inner[, inner mask])
        self._memories: List[_Memory] = []
        self._step_outputs: List[Variable] = []
        self.outputs: List[Variable] = []
        self.final_memories: List[Variable] = []

    @contextlib.contextmanager
    def step(self):
        if self._status != self.BEFORE:
            raise RuntimeError("step() may only be entered once")
        with self.helper.main_program.block_guard() as b:
            self._block = b
            self._status = self.IN
            yield
            self._status = self.AFTER
        self._complete()

    def _require_in_step(self, what: str):
        if self._status != self.IN:
            raise RuntimeError(f"{what} must be called inside rnn.step()")

    def step_input(self, seq: Variable) -> Variable:
        """A ragged sequence input; returns its [B, ...] slice at step t."""
        self._require_in_step("step_input")
        if seq.lod_level < 1:
            raise ValueError(f"step_input needs a sequence (lod_level>=1): {seq.name}")
        inner = self._block.create_var(unique_name(f"{self.helper.name}.in"), tuple(seq.shape),
                                       seq.dtype)
        self._seq_pairs.append((seq, inner))
        return inner

    def static_input(self, var: Variable) -> Variable:
        """The identity: the enclosing block's values are visible in the
        step already (the reference's StaticInput)."""
        return var

    def memory(self, init: Optional[Variable] = None, shape=None, init_value: float = 0.0,
               dtype=np.float32) -> Variable:
        """Carried state: booted from the dense [B, ...] `init`, else
        `init_value` over [B] + shape in `dtype`."""
        self._require_in_step("memory")
        if init is None and shape is None:
            raise ValueError("memory() needs either init= or shape=")
        var_shape = tuple(init.shape) if init is not None else (-1,) + tuple(shape)
        inner = self._block.create_var(unique_name(f"{self.helper.name}.mem"), var_shape,
                                       init.dtype if init is not None else dtype)
        self._memories.append(_Memory(inner, init, shape or (), init_value))
        return inner

    def update_memory(self, mem: Variable, new: Variable) -> None:
        self._require_in_step("update_memory")
        for m in self._memories:
            if m.inner.name == mem.name:
                if m.update is not None:
                    raise ValueError(f"memory {mem.name} updated twice")
                m.update = new
                return
        raise ValueError(f"{mem.name} is not a memory of this group")

    def step_output(self, var: Variable) -> None:
        self._require_in_step("step_output")
        self._step_outputs.append(var)

    output = step_output

    def _check_complete(self):
        if not self._seq_pairs:
            raise ValueError(f"{self.op_type} needs at least one step_input")
        for m in self._memories:
            if m.update is None:
                raise ValueError(f"memory {m.inner.name} never updated")
        if not self._step_outputs:
            raise ValueError(f"{self.op_type} needs at least one step_output")

    def _emit(self, out_lod_level: int, inputs_attrs: dict):
        """The outputs, the final memories and the op in the enclosing
        block."""
        helper = self.helper
        parent = helper.block  # after rollback: the enclosing block
        for v in self._step_outputs:
            self.outputs.append(parent.create_var(unique_name(f"{helper.name}.out"),
                                                  tuple(v.shape), v.dtype,
                                                  lod_level=out_lod_level))
        for m in self._memories:
            self.final_memories.append(parent.create_var(unique_name(f"{helper.name}.final"),
                                                         tuple(m.inner.shape), m.inner.dtype))
        parent.append_op(
            self.op_type,
            inputs={"Seq": [p[0].name for p in self._seq_pairs],
                    "Boot": [m.boot.name for m in self._memories if m.boot is not None]},
            outputs={"Out": [v.name for v in self.outputs],
                     "FinalMem": [v.name for v in self.final_memories]},
            attrs={"sub_block": self._block.idx,
                   "seq_inner": [p[1].name for p in self._seq_pairs],
                   **inputs_attrs,
                   "mem_inner": [m.inner.name for m in self._memories],
                   "mem_update": [m.update.name for m in self._memories],
                   "mem_has_boot": [m.boot is not None for m in self._memories],
                   "mem_shape": [list(m.shape) for m in self._memories],
                   "mem_init_value": [m.init_value for m in self._memories],
                   "mem_dtype": [np.dtype(m.inner.dtype).name for m in self._memories],
                   "out_inner": [v.name for v in self._step_outputs],
                   **self._tail_attrs()})

    def _tail_attrs(self) -> dict:
        return {"is_reverse": self.is_reverse, "max_len": self.max_len}

    def _complete(self):
        self._check_complete()
        self._emit(self._seq_pairs[0][0].lod_level, {})

    def __call__(self):
        if self._status != self.AFTER:
            raise RuntimeError("call after the step() block has closed")
        return self.outputs[0] if len(self.outputs) == 1 else tuple(self.outputs)

    def get_final_memory(self, idx: int = 0) -> Variable:
        """The idx-th memory's dense [B, ...] value at each sequence's end."""
        return self.final_memories[idx]


StaticRNN = RecurrentGroup  # the Fluid name of the same machinery


def recurrent_group(step_fn, inputs, is_reverse: bool = False, max_len=None):
    """The Gen-1 functional form: `step_fn(*step_slices, rnn)` gets each
    input's slice and the group (for memory/update_memory) and returns the
    step's output(s)."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    rnn = RecurrentGroup(is_reverse=is_reverse, max_len=max_len)
    with rnn.step():
        outs = step_fn(*[rnn.step_input(v) for v in inputs], rnn)
        for o in outs if isinstance(outs, (list, tuple)) else [outs]:
            rnn.step_output(o)
    return rnn()


class NestedRecurrentGroup(RecurrentGroup):
    """An outer recurrence over the sub-sequences of a 2-level input
    (`recurrent_group(step, input=SubsequenceInput(x))`): each frame gets
    one whole sub-sequence of every sequence, [B, max_sublen, ...] with its
    [B, max_sublen] mask, and the output has one token a sub-sequence::

        rnn = ptt.layers.NestedRecurrentGroup(max_subseqs=4, max_sublen=8)
        with rnn.step():
            sub, sub_mask = rnn.step_input(x2)
            h_prev = rnn.memory(shape=[H])
            ...                                  # reduce sub, combine
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                              # lod_level 1

    Sequences with more than max_subseqs sub-sequences and sub-sequences
    longer than max_sublen are cut. A padded frame runs the step on zeros
    (masked out of the memories and outputs, but its gradient flows
    through torch.where): guard divisions against the empty case."""

    op_type = "nested_recurrent_group"

    def __init__(self, max_subseqs: int, max_sublen: int, name=None):
        super().__init__(name=name)
        # a helper of its own after the base's, whose name the base drew
        # (the JAX front end's names, counter and all)
        self.helper = LayerHelper(self.op_type, name=name)
        self.max_subseqs = int(max_subseqs)
        self.max_sublen = int(max_sublen)

    def step_input(self, seq: Variable):
        """A 2-level sequence; returns (dense [B, L, ...], mask [B, L])."""
        self._require_in_step("step_input")
        if seq.lod_level < 2:
            raise ValueError(f"NestedRecurrentGroup needs lod_level=2 input: {seq.name}")
        trailing = tuple(d for d in seq.shape[1:] if d != -1)
        inner = self._block.create_var(unique_name(f"{self.helper.name}.sub"),
                                       (-1, self.max_sublen) + trailing, seq.dtype)
        mask = self._block.create_var(unique_name(f"{self.helper.name}.submask"),
                                      (-1, self.max_sublen), np.bool_)
        self._seq_pairs.append((seq, inner, mask))
        return inner, mask

    def _tail_attrs(self) -> dict:
        return {"max_subseqs": self.max_subseqs, "max_sublen": self.max_sublen}

    def _complete(self):
        self._check_complete()
        self._emit(1, {"seq_inner_mask": [p[2].name for p in self._seq_pairs]})
