"""BeamSearchDecoder: generation over an arbitrary step sub-network
(paddle_tpu/layers/generation.py).

The step body is a program sub-block; the `beam_search_group` op
(ops/generation_ops.py) runs it over the [B, K] beam state for `max_len`
steps, gathering the memories by beam parent each step and freezing finished
hypotheses, then backtracks the (parent, token) trellis. Greedy decoding is
beam_size=1. A program built here serializes to the dict the JAX package's
front end gives.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np

from ..core.program import Variable, unique_name
from ..ops.generation_ops import (DecodeState, GenSpec, beam_step,  # noqa: F401
                                  find_generation_op, gen_spec_from_op)
from .helper import LayerHelper

__all__ = ["BeamSearchDecoder", "GenSpec", "DecodeState", "beam_step",
           "find_generation_op", "gen_spec_from_op"]


class _GenMemory:
    def __init__(self, inner: Variable, boot: Variable):
        self.inner = inner
        self.boot = boot
        self.update: Optional[Variable] = None


class BeamSearchDecoder:
    """Generate sequences with an arbitrary step network.

    Usage::

        gen = ptt.layers.BeamSearchDecoder(beam_size=4, max_len=32,
                                           bos_id=0, eos_id=1)
        with gen.step():
            prev = gen.prev_ids()               # [N] int32, N = B*K
            h_prev = gen.memory(init=h0)        # boot [B, H] -> [N, H]
            emb = ptt.layers.embedding(prev, size=[V, E])
            h = ...layers over emb/h_prev...
            gen.update_memory(h_prev, h)
            gen.output_logits(ptt.layers.fc(h, size=V))
        ids, scores, lengths = gen()            # [B,K,T], [B,K], [B,K]

    Values from the enclosing scope are visible inside the step; a dense
    per-example tensor (leading dim B, e.g. projected encoder states for
    attention) must be declared with `gen.per_example_input(var)` so it is
    tiled to the beam (leading dim B*K) before the decode."""

    BEFORE, IN, AFTER = 0, 1, 2

    def __init__(
        self,
        beam_size: int = 4,
        max_len: int = 32,
        bos_id: int = 0,
        eos_id: int = 1,
        length_normalize: bool = False,
        name=None,
    ):
        self.helper = LayerHelper("beam_search_group", name=name)
        self.beam_size = beam_size
        self.max_len = max_len
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.length_normalize = length_normalize
        self._status = self.BEFORE
        self._block = None
        self._prev_ids: Optional[Variable] = None
        self._memories: List[_GenMemory] = []
        self._per_example: List[Variable] = []
        self._logits: Optional[Variable] = None
        self.outputs: Tuple[Variable, ...] = ()

    @contextlib.contextmanager
    def step(self):
        if self._status != self.BEFORE:
            raise RuntimeError("step() may only be entered once")
        prog = self.helper.main_program
        with prog.block_guard() as b:
            self._block = b
            self._status = self.IN
            yield
            self._status = self.AFTER
        self._complete()

    def _require_in_step(self, what: str):
        if self._status != self.IN:
            raise RuntimeError(f"{what} must be called inside gen.step()")

    def prev_ids(self) -> Variable:
        """The token each live hypothesis emitted at the previous step

        (bos at t=0) — the reference's GeneratedInput."""
        self._require_in_step("prev_ids")
        if self._prev_ids is None:
            self._prev_ids = self._block.create_var(
                unique_name(f"{self.helper.name}.prev"), (-1,), np.int32
            )
        return self._prev_ids

    def memory(self, init: Variable) -> Variable:
        """Carried state booted from a dense [B, ...] variable."""
        self._require_in_step("memory")
        inner = self._block.create_var(
            unique_name(f"{self.helper.name}.mem"), tuple(init.shape), init.dtype
        )
        self._memories.append(_GenMemory(inner, init))
        return inner

    def update_memory(self, mem: Variable, new: Variable) -> None:
        self._require_in_step("update_memory")
        for m in self._memories:
            if m.inner.name == mem.name:
                if m.update is not None:
                    raise ValueError(f"memory {mem.name} updated twice")
                m.update = new
                return
        raise ValueError(f"{mem.name} is not a memory of this decoder")

    def per_example_input(self, var: Variable) -> Variable:
        """Declare a dense per-example closure tensor (leading dim B) that

        must be tiled to [B*K, ...] for the step body (e.g. encoder states
        feeding attention)."""
        self._require_in_step("per_example_input")
        self._per_example.append(var)
        return var

    def output_logits(self, logits: Variable) -> None:
        """[N, V] unnormalized next-token scores."""
        self._require_in_step("output_logits")
        if self._logits is not None:
            raise ValueError("output_logits called twice")
        self._logits = logits

    # ------------------------------------------------------------------
    def _complete(self):
        if self._prev_ids is None:
            raise ValueError("beam search step must read gen.prev_ids()")
        if self._logits is None:
            raise ValueError("beam search step must call output_logits")
        for m in self._memories:
            if m.update is None:
                raise ValueError(f"memory {m.inner.name} never updated")
        helper = self.helper
        parent = helper.block
        K, T = self.beam_size, self.max_len
        ids = parent.create_var(
            unique_name(f"{helper.name}.ids"), (-1, K, T), np.int32
        )
        scores = parent.create_var(
            unique_name(f"{helper.name}.scores"), (-1, K), np.float32
        )
        lengths = parent.create_var(
            unique_name(f"{helper.name}.lengths"), (-1, K), np.int32
        )
        parent.append_op(
            "beam_search_group",
            inputs={
                "Boot": [m.boot.name for m in self._memories],
                "PerExample": [v.name for v in self._per_example],
            },
            outputs={
                "Ids": [ids.name],
                "Scores": [scores.name],
                "Lengths": [lengths.name],
            },
            attrs={
                "sub_block": self._block.idx,
                "prev_inner": self._prev_ids.name,
                "mem_inner": [m.inner.name for m in self._memories],
                "mem_update": [m.update.name for m in self._memories],
                "per_example": [v.name for v in self._per_example],
                "logits_inner": self._logits.name,
                "beam_size": K,
                "max_len": T,
                "bos_id": self.bos_id,
                "eos_id": self.eos_id,
                "length_normalize": self.length_normalize,
            },
        )
        self.outputs = (ids, scores, lengths)

    def __call__(self):
        if self._status != self.AFTER:
            raise RuntimeError("call after the step() block has closed")
        return self.outputs
