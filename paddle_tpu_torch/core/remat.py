"""Rematerialization of a training step's forward (`memory_optimize`,
paddle_tpu/core/executor.py:36-56, 216-224, 276-278).

The JAX package wraps the whole forward slice in one `jax.checkpoint` with
a policy: `full` keeps nothing from inside it, `dots` the outputs of
`dot_general` and `conv_general_dilated`, `dots_no_batch` only the
`dot_general` outputs without batch dimensions; everything else is
recomputed in the backward pass. XLA schedules that recompute op by op.
One `torch.utils.checkpoint` around the whole forward would save nothing:
the backward's first unpack recomputes the whole region and then holds all
of its saved tensors at once. So the forward runs as segments, each
checkpointed on its own (non-reentrant), and the backward recomputes one
segment at a time:

- **Segments.** Every policy cuts the forward's ops into runs of
  ceil(sqrt(n)) ops, n the forward's op count: about sqrt(n) boundaries
  live through the step, and one segment's saved tensors at a time in the
  backward.
- **What a policy keeps.** Inside a segment under `dots` or
  `dots_no_batch`, a selective-checkpoint policy keeps the output of every
  aten product the JAX policy keeps (`KEPT_ATEN`): `mm`, `addmm`, `bmm`,
  `baddbmm` and `convolution` under `dots`; `mm` and `addmm` under
  `dots_no_batch`. The recompute takes them from that cache instead of
  running the product again. The port's ops that reach them are those
  whose JAX bodies lower to `dot_general` or `conv_general_dilated`:
  `mul` (fc's product), `matmul` (`bmm` with batch dimensions),
  `conv2d`, `conv2d_transpose` and `sequence_conv`. The hand kernels
  (flash attention, the LSTM and GRU kernels) are launched through
  ctypes, never an aten product: they are recomputed under every policy,
  as a Pallas call is never a dot in the JAX package.
- **Live values.** A segment runs on its own env, built from its inputs
  (an op that runs sub-blocks, a recurrent group's or a While's, also
  reads what their ops read of the enclosing block) when it starts, and hands back each name read after it (a later op's
  input, the loss, a fetch, a persistable) that it bound anew: its
  declared outputs, and a value an op rebinds under an input's name, as
  batch_norm, bn_stats and fused_conv_bn write the new running statistics
  under their Mean and Variance inputs' names. Its other values die with
  it. The recompute reads the same inputs again, so it recomputes the new
  statistics from the old ones, and what it hands back is discarded.
- **Ops that run once.** An op whose registration declares `runs_once`
  (core/registry.py) takes an effect that must happen once a step: a draw
  from the run's generator (`dropout` in training, the `*_random` ops) or
  a site recorded on the SparseGradTape (an `is_sparse` table's
  `lookup_table`). It runs between segments and is never recomputed: its
  draw or its site is taken once, and its output is kept (dropout's mask
  is what autograd saves for its backward). A kernel that takes such an
  effect inside a segment without the declaration raises
  (`OpContext.once`), where its recompute would silently draw again.
  Restoring the generator around a recompute instead would hold in eager
  steps only: while a window's step is captured, a CUDA generator's state
  can be neither cloned nor set back (both raise), and the only states it
  can be swapped to are other generators registered with the graph before
  the capture, each with offsets of its own (experiments/remat_probe.py).

The recompute runs the same kernels on the same inputs, so a remat step
gives the plain step's bits.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from . import registry

REMAT_POLICIES = ("full", "dots", "dots_no_batch")

_aten = torch.ops.aten
# the aten products each policy keeps (jax.checkpoint_policies.dots_saveable
# and dots_with_no_batch_dims_saveable)
KEPT_ATEN = {
    "full": frozenset(),
    "dots": frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                       _aten.baddbmm.default, _aten.convolution.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}


def segments(ops: Sequence, env=None) -> List[Tuple[int, int, bool]]:
    """(start, end, checkpointed) spans covering ops[0:len(ops)] in order:
    runs of at most ceil(sqrt(n)) ops, and each op that runs once (its
    registration's `runs_once` on the run's `env`) alone."""
    n = len(ops)
    size = max(1, math.ceil(math.sqrt(n)))
    spans, start = [], 0
    for i, op in enumerate(ops):
        if registry.runs_once(op, env or {}):
            if start < i:
                spans.append((start, i, True))
            spans.append((i, i + 1, False))
            start = i + 1
        elif i + 1 - start >= size:
            spans.append((start, i + 1, True))
            start = i + 1
    if start < n:
        spans.append((start, n, True))
    return spans


def _names(op, slots) -> List[str]:
    return [n for names in slots(op).values() for n in names]


def _reads(op, program) -> List[str]:
    """The names `op` reads: its inputs, and those of the ops of the
    sub-blocks it runs, which close over the enclosing block's values."""
    return _names(op, lambda o: o.inputs) + [
        n for b in registry.sub_blocks(op, program) for o in b.ops for n in _reads(o, program)]


def _policy_fn(kept, ctx, func, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if func in kept else CheckpointPolicy.PREFER_RECOMPUTE


def run_forward(runner, ops: Sequence, env: Dict, block, policy: str, read_after) -> None:
    """The forward ops on `env` as checkpointed segments (the module
    docstring). `read_after`: the names read once the forward is done (the
    autodiff op's and later ops' inputs, the fetches, the persistables)."""
    spans = segments(ops, env)
    # the names each span's successors read, from the last span back
    later = [set() for _ in spans]
    acc = set(read_after)
    for s in range(len(spans) - 1, -1, -1):
        later[s] = set(acc)
        a, b, _ = spans[s]
        for op in ops[a:b]:
            acc.update(_reads(op, runner.program))
    special = {k: v for k, v in env.items() if k.startswith("@")}
    kept = KEPT_ATEN[policy]
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    functools.partial(_policy_fn, kept)) if kept else None)
    for (a, b, ckpt), needed in zip(spans, later):
        if not ckpt:
            runner.run_ops(ops[a:b], env, block, first=a)
            continue
        ins, written = {}, set()
        for op in ops[a:b]:
            for name in _reads(op, runner.program):
                if name not in written and name in env:
                    ins[name] = env[name]
            written.update(_names(op, lambda o: o.outputs))
        # no early stop: it ends a recompute by raising through the ops,
        # which the runner would report as the op's failure
        with set_checkpoint_early_stop(False):
            env.update(checkpoint(_segment, runner, ops, a, b, block, special, ins, needed,
                                  use_reentrant=False, preserve_rng_state=False,
                                  **({"context_fn": context_fn} if context_fn else {})))


def _segment(runner, ops, a, b, block, special, ins, needed):
    """ops[a:b] on an env of their own: the forward's run and the backward's
    recompute. Returns each needed name the segment bound anew, declared
    output or not."""
    local = dict(special)
    local[registry.REMAT_KEY] = True
    local.update(ins)
    runner.run_ops(ops[a:b], local, block, first=a)
    return {n: v for n, v in local.items()
            if n in needed and (n not in ins or v is not ins[n])}
