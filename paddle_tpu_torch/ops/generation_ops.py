"""The beam_search_group op and its decode step
(paddle_tpu/ops/generation_ops.py).

The step network is a program sub-block run on the flattened [B*K, ...]
beam batch by the Executor's `BlockRunner` (core/executor.py). One decode
step is factored out as `beam_step` with an explicit carried state, so two
consumers run the same arithmetic:

- the `beam_search_group` kernel loops it over `max_len` steps for the
  whole request batch (batch mode), then backtracks and finalizes;
- `serving/scheduler.py` wraps it with slot masking into a pool step for
  continuous batching, captured as one CUDA graph on the card.

Every op of a step, and log_softmax and the top-K pruning, is independent
along the example axis, so a slot of a pool step computes what its example
computes in a batch-mode step of the same shape: the scheduler's answers
equal the op's bit for bit.

Where the JAX op scans with `lax.scan` and folds the step index into its
random key, this one runs the steps eagerly, the sub-block's random ops
drawing from the run's generator in turn.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.lod import LoDArray
from ..core.registry import LIVE_KEY, register_op
from . import beam_common

__all__ = [
    "GenSpec",
    "DecodeState",
    "beam_step",
    "greedy_step",
    "find_generation_op",
    "gen_spec_from_op",
]


class GenSpec(NamedTuple):
    """Static description of one beam_search_group op: what a consumer needs
    to run the step sub-block outside the op kernel."""

    beam_size: int
    max_len: int
    bos_id: int
    eos_id: int
    length_normalize: bool
    sub_block: int
    prev_inner: str
    mem_inner: Tuple[str, ...]
    mem_update: Tuple[str, ...]
    per_example: Tuple[str, ...]  # inner names the step body reads
    logits_inner: str
    boot_names: Tuple[str, ...]  # block-0 vars booting each memory
    per_example_names: Tuple[str, ...]  # block-0 vars tiled to the beam
    out_names: Tuple[str, str, str]  # (Ids, Scores, Lengths) var names


class DecodeState(NamedTuple):
    """The decode pool's state, S slots of one example with K hypotheses
    each. `parents`/`trellis_tok` are the (parent, token) trellis written a
    column a step; a retiring slot is backtracked over its own `step[s]`
    columns only, so stale columns of a previous occupant are never read."""

    mems: Tuple[torch.Tensor, ...]  # each [S, K, ...]
    tok: torch.Tensor  # [S, K] int32, the token emitted at the last step
    scores: torch.Tensor  # [S, K] float32 cumulative log-probs
    fin: torch.Tensor  # [S, K] bool
    step: torch.Tensor  # [S] int32, the decode position of each slot
    parents: torch.Tensor  # [S, K, T] int32 trellis
    trellis_tok: torch.Tensor  # [S, K, T] int32 trellis
    pe: Tuple[torch.Tensor, ...]  # per-example tensors, each [S*K, ...]


def find_generation_op(program):
    """The block-0 beam_search_group op, or None (not a generation model)."""
    for op in program.global_block().ops:
        if op.type == "beam_search_group":
            return op
    return None


def gen_spec_from_op(op) -> GenSpec:
    return GenSpec(
        beam_size=int(op.attrs.get("beam_size", 4)),
        max_len=int(op.attrs.get("max_len", 32)),
        bos_id=int(op.attrs.get("bos_id", 0)),
        eos_id=int(op.attrs.get("eos_id", 1)),
        length_normalize=bool(op.attrs.get("length_normalize", False)),
        sub_block=int(op.attrs["sub_block"]),
        prev_inner=op.attrs["prev_inner"],
        mem_inner=tuple(op.attrs.get("mem_inner", ())),
        mem_update=tuple(op.attrs.get("mem_update", ())),
        per_example=tuple(op.attrs.get("per_example", ())),
        logits_inner=op.attrs["logits_inner"],
        boot_names=tuple(op.inputs.get("Boot", [])),
        per_example_names=tuple(op.inputs.get("PerExample", [])),
        out_names=(op.outputs["Ids"][0], op.outputs["Scores"][0], op.outputs["Lengths"][0]),
    )


def _data(x):
    return x.data if isinstance(x, LoDArray) else x


def _along(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B, K] index expanded over `like`'s trailing axes, for a gather
    along axis 1 (jnp.take_along_axis)."""
    return idx.reshape(idx.shape + (1,) * (like.dim() - 2)).expand(like.shape)


def beam_step(runner, block, spec: GenSpec, env: Dict[str, Any], mems, tok, sc, fin):
    """ONE beam-search decode step over a [B, K] hypothesis batch.

    `env` must already hold what the step sub-block closes over: the
    parameters, the per-example tensors tiled to [B*K, ...] under
    `spec.per_example`'s names, the amp dtype and the generator. The
    sub-block's ops write into it: pass a copy for each step.

    Returns (new_mems, new_tok, new_sc, new_fin, parent): the state after
    expand and prune, and the parent pointers for the trellis."""
    B, K = tok.shape
    env[spec.prev_inner] = tok.reshape(B * K)
    for name, m in zip(spec.mem_inner, mems):
        env[name] = m.reshape((B * K,) + tuple(m.shape[2:]))
    runner.run_ops(block.ops, env, block)
    logits = _data(env[spec.logits_inner])
    V = logits.shape[-1]
    logits = logits.reshape(B, K, V).float()
    new_mems = tuple(
        torch.where(fin.reshape((B, K) + (1,) * (m.dim() - 2)), m,
                    _data(env[u]).reshape(m.shape))
        for u, m in zip(spec.mem_update, mems))
    logp = torch.log_softmax(logits, dim=-1)
    logp = beam_common.freeze_finished(logp, fin, spec.eos_id)
    top_sc, parent, new_tok = beam_common.expand_prune(sc, logp, K)
    sel_mems = tuple(torch.gather(m, 1, _along(parent, m)) for m in new_mems)
    new_fin = torch.gather(fin, 1, parent) | (new_tok == spec.eos_id)
    return sel_mems, new_tok, top_sc, new_fin, parent


def greedy_step(runner, block, spec: GenSpec, env: Dict[str, Any], mems, tok):
    """ONE greedy (single-hypothesis) decode step over a [B] batch: the
    step sub-block with K = 1 and no beam bookkeeping. `mems` are [B, ...],
    `tok` is [B] int32; `env` as for `beam_step`. Returns (new_mems,
    new_tok), new_tok the argmax of the step's logits. (Its consumer, the
    speculative draft, waits for ROADMAP.md A8b.)"""
    env[spec.prev_inner] = tok
    for name, m in zip(spec.mem_inner, mems):
        env[name] = m
    runner.run_ops(block.ops, env, block)
    logits = _data(env[spec.logits_inner]).float()
    new_mems = tuple(_data(env[u]).reshape(m.shape) for u, m in zip(spec.mem_update, mems))
    return new_mems, torch.argmax(logits, dim=-1).to(torch.int32)


def step_env(base: Dict[str, Any]) -> Dict[str, Any]:
    """The env a step sub-block runs on: `base` without the enclosing
    block's read set, so every output of the sub-block counts as read
    (registry.OpContext.output_read)."""
    env = dict(base)
    env.pop(LIVE_KEY, None)
    return env


@register_op("beam_search_group")
def beam_search_group_kernel(ctx):
    boots = [_data(b) for b in ctx.inputs("Boot")]
    spec = gen_spec_from_op(ctx.op)
    K, T = spec.beam_size, spec.max_len
    if not boots:
        raise ValueError("beam_search_group needs at least one booted memory")
    B = boots[0].shape[0]
    dev = boots[0].device
    runner = ctx.executor
    block = runner.program.blocks[spec.sub_block]
    outer = step_env(ctx.env)
    # the per-example closure tensors shadowed by their beam-tiled versions
    for name, v in zip(spec.per_example, ctx.inputs("PerExample")):
        outer[name] = torch.repeat_interleave(_data(v), K, dim=0)
    mems = tuple(b[:, None].expand((B, K) + tuple(b.shape[1:])) for b in boots)
    tok = torch.full((B, K), spec.bos_id, dtype=torch.int32, device=dev)
    sc = beam_common.init_scores(B, K, device=dev)
    fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
    parents, toks = [], []
    for _ in range(T):
        mems, tok, sc, fin, parent = beam_step(runner, block, spec, dict(outer), mems, tok,
                                               sc, fin)
        parents.append(parent)
        toks.append(tok)
    ids = beam_common.backtrack(parents, toks, B, K)
    ids, out_scores, lengths = beam_common.finalize(ids, sc, spec.eos_id, T,
                                                    spec.length_normalize)
    ctx.set_output("Ids", ids)
    ctx.set_output("Scores", out_scores)
    ctx.set_output("Lengths", lengths)
