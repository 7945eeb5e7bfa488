"""Stage partitioning: split a Program's forward block into K stages
(paddle_tpu/pipeline/partition.py, copied so that the port cuts every
Program exactly where the JAX package cuts it).

The reference's Gen-1 `ParallelNeuralNetwork` placed whole layers on
numbered devices by per-layer `device` attrs (PAPER §Gen-1). Here, as in
the JAX package, that is a partition of block 0's forward op span into K
contiguous stages, cut at user-placed markers (`stage_boundary()`, the
device attr as an op) or by balancing a per-op cost (parameter bytes plus a
FLOPs estimate, `_op_cost`) with the linear-partition DP
(`_balanced_cuts`), then sliding each cut to the narrowest nearby boundary
(`_narrow_cuts`).

A boundary between stages s and s+1 carries exactly the non-persistable
values produced at stages <= s and read at stages > s (skip connections
ride through intermediate boundaries). Persistables never cross one: each
stage reads them from the scope's state. pipeline/schedule.py runs the
partition as the micro-batch schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.program import Operator, Program
from ..core import registry

# the boundary marker op: a no-op at trace time (a registered kernel so
# the UNstaged executor runs marked programs unchanged), a cut point to
# split_program. The reference's `device=k` layer attr, as an op.
STAGE_BOUNDARY_OP = "pipeline_stage"


@registry.register_op(STAGE_BOUNDARY_OP)
def _stage_boundary_kernel(ctx):  # noqa: ARG001 — deliberate no-op
    pass


def stage_boundary(program: Optional[Program] = None) -> None:
    """Mark a pipeline cut point at the current position of the model
    being built. `split_program(..., num_stages=None)` cuts exactly at
    the markers; with `num_stages=K` given, markers win over the
    automatic balancer when their count matches K-1."""
    from ..core.program import default_main_program

    program = program or default_main_program()
    program.current_block().append_op(
        type=STAGE_BOUNDARY_OP, inputs={}, outputs={}, attrs={})


@dataclass
class Stage:
    """One contiguous forward span plus its dataflow contract."""

    index: int
    ops: List[Operator]
    # non-persistable activations entering from the previous stage's
    # boundary buffer (empty for stage 0)
    in_names: Tuple[str, ...]
    # activations this stage must hand to the NEXT boundary buffer
    # (produced here or passed through; empty for the last stage)
    out_names: Tuple[str, ...]
    # feed slots this stage consumes directly (stage 0 takes the model
    # inputs; a later stage may take e.g. the labels)
    feed_names: Tuple[str, ...]
    # persistable names any op of this stage reads (params, statics)
    state_names: Tuple[str, ...]
    cost: float = 0.0


@dataclass
class StagedProgram:
    """split_program's result: the stage list plus everything the
    scheduler needs to rebuild the unstaged semantics."""

    program: Program
    stages: List[Stage]
    loss_name: str
    param_names: Tuple[str, ...]       # autodiff's dense param set
    tail_ops: List[Operator]           # grad-clip + optimizer ops
    # forward-produced names the tail consumes (must be scalar; averaged
    # over microbatches before the tail runs — e.g. a loss-scaling read)
    tail_fwd_names: Tuple[str, ...]
    costs: List[float] = field(default_factory=list)

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def boundary_signature(self) -> List[Tuple[Tuple[tuple, str], ...]]:
        """(shape, dtype) tuples per boundary, for the scheduler's
        homogeneity check (stacked pp-sharded buffers need identical
        signatures at every boundary)."""
        block = self.program.global_block()
        sigs = []
        for st in self.stages[:-1]:
            sig = []
            for n in st.out_names:
                v = block.var(n)
                sig.append((tuple(v.shape), str(np.dtype(v.dtype).name)))
            sigs.append(tuple(sig))
        return sigs


def _op_cost(op: Operator, block) -> float:
    """Per-op balance weight: parameter bytes (counted where consumed)
    plus a coarse FLOPs estimate. Batch dims (-1) count as 1 — every
    stage sees the same microbatch factor, so it cancels out of the
    balance. This is an ESTIMATE for cut placement, not a perf model:
    matmul-family ops dominate via their weight panels, elementwise ops
    via their output extent."""
    param_elems = 0
    param_bytes = 0.0
    for n in op.input_names():
        try:
            v = block.var(n)
        except KeyError:
            continue
        if v.persistable and all(int(d) > 0 for d in v.shape):
            elems = int(np.prod(v.shape))
            param_elems += elems
            param_bytes += elems * np.dtype(v.dtype).itemsize
    out_elems = 0
    for n in op.output_names():
        try:
            v = block.var(n)
        except KeyError:
            continue
        if v.shape:
            out_elems += int(np.prod([max(int(d), 1) for d in v.shape]))
    # 2 FLOPs/MAC against every consumed weight element approximates the
    # matmul/conv cost; out_elems covers elementwise/normalization ops
    return float(param_bytes + 2.0 * param_elems + out_elems)


def _balanced_cuts(costs: Sequence[float], k: int) -> List[int]:
    """Cut indices (exclusive prefix lengths) minimizing the max stage
    cost — the classic linear-partition DP (n and k are both small: op
    counts in the hundreds, k single digits)."""
    n = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    inf = float("inf")
    # best[j][i] = minimal max-stage-cost splitting costs[:i] into j parts
    best = [[inf] * (n + 1) for _ in range(k + 1)]
    back = [[0] * (n + 1) for _ in range(k + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for c in range(j - 1, i):
                cand = max(best[j - 1][c], prefix[i] - prefix[c])
                if cand < best[j][i]:
                    best[j][i] = cand
                    back[j][i] = c
    cuts = []
    i = n
    for j in range(k, 1, -1):
        i = back[j][i]
        cuts.append(i)
    cuts.reverse()
    return cuts


def _narrow_cuts(
    body_ops: Sequence[Operator],
    costs: Sequence[float],
    cuts: List[int],
    persist: set,
    feed_like: set,
    program: Program,
    block,
    tol: float = 1.3,
) -> List[int]:
    """Refine DP-balanced cuts to the NARROWEST nearby boundary.

    The DP minimizes max stage cost alone, which happily cuts between a
    matmul and its bias add — a two-tensor boundary through the middle
    of an fc. Narrow boundaries matter twice: they are the cross-stage
    traffic the pp axis actually moves, and they are what keeps the
    staged backward bit-identical to the unstaged one (a cut through a
    fused op pair materializes a cotangent XLA would otherwise fuse,
    and the refused fusion reassociates the upstream gradient
    reductions — observed, not theorized: the transformer A/B in
    tests/test_pipeline.py fails bitwise on mid-fc cuts and passes on
    residual-stream cuts). Each cut slides within its neighbor span to
    the position minimizing (tensor count, bytes, distance), subject to
    the adjacent stage costs staying within tol x the DP optimum."""
    n = len(body_ops)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    bounds = [0] + list(cuts) + [n]
    opt = max(prefix[e] - prefix[b] for b, e in zip(bounds, bounds[1:]))
    budget = opt * tol

    # suffix_need[c]: names ops[c:] read before producing locally
    suffix_need: List[set] = [set() for _ in range(n + 1)]
    need: set = set()
    for i in range(n - 1, -1, -1):
        op = body_ops[i]
        need = need - set(op.output_names())
        need |= set(op.input_names())
        need |= _sub_block_refs(program, op)
        suffix_need[i] = set(need)

    def nbytes(names):
        total = 0.0
        for nm in names:
            v = _var_or_none(block, nm)
            if v is not None and v.shape:
                total += (np.prod([max(int(d), 1) for d in v.shape])
                          * np.dtype(v.dtype).itemsize)
        return total

    widths: List[Tuple[int, float]] = []
    prod: set = set()
    for c in range(n + 1):
        cross = (prod & suffix_need[c]) - persist - feed_like
        widths.append((len(cross), nbytes(cross)))
        if c < n:
            prod |= set(body_ops[c].output_names())

    refined: List[int] = []
    for j, c0 in enumerate(cuts):
        lo = (refined[-1] if refined else 0) + 1
        hi = (cuts[j + 1] if j + 1 < len(cuts) else n) - 1
        best = c0
        best_key = None
        for c in range(lo, hi + 1):
            left = prefix[c] - prefix[refined[-1] if refined else 0]
            right = prefix[(cuts[j + 1] if j + 1 < len(cuts) else n)] \
                - prefix[c]
            if left > budget or right > budget:
                continue
            key = (widths[c][0], widths[c][1], abs(c - c0))
            if best_key is None or key < best_key:
                best_key = key
                best = c
        refined.append(best)
    return refined


def split_program(
    program: Program,
    num_stages: Optional[int] = None,
    extra_targets: Sequence[str] = (),
) -> StagedProgram:
    """Partition block 0 into K stages.

    num_stages=None cuts at the `stage_boundary()` markers; an explicit
    K without (matching) markers runs the automatic cost balancer.
    extra_targets (fetch names) are validated to be forward-produced so
    the scheduler can collect them at their producing stage.
    """
    block = program.global_block()
    ops = list(block.ops)
    ad_idx = next(
        (i for i, op in enumerate(ops) if op.type == "autodiff"), None)
    if ad_idx is None:
        raise ValueError(
            "split_program needs a training program (autodiff op present)"
            " — inference programs run unstaged")
    ad_op = ops[ad_idx]
    fwd_ops = ops[:ad_idx]
    tail_ops = ops[ad_idx + 1:]
    loss_name = ad_op.inputs["Loss"][0]
    param_names = tuple(ad_op.attrs["params"])
    sparse = [p for p in param_names
              if getattr(_var_or_none(block, p), "sparse_update", False)]
    if sparse:
        raise NotImplementedError(
            f"pipeline: sparse_update params {sparse} (SelectedRows "
            "gradients) are not supported by the staged schedule — "
            "rebuild the embedding with is_sparse=False")

    # forward ops must not WRITE persistables (e.g. batch-norm running
    # stats in train mode): the micro-batch schedule would apply M
    # partial updates in schedule order, silently changing semantics
    persist = {v.name for v in program.persistables()}
    writers = [
        op.type for op in fwd_ops
        if any(n in persist for n in op.output_names())
        and op.type != STAGE_BOUNDARY_OP
    ]
    # batch_norm updates its running stats through the Mean/Variance
    # INPUT bindings (the kernel writes ctx.env[input_name] — see
    # ops/nn_ops.py), which the structural outputs-scan above can't see
    writers += [
        op.type for op in fwd_ops
        if op.type == "batch_norm" and not op.attrs.get("is_test", False)
    ]
    if writers:
        raise NotImplementedError(
            f"pipeline: forward ops {sorted(set(writers))} update "
            "persistable state — micro-batch staging of stateful "
            "forward passes (batch_norm train mode) is not supported; "
            "use normalization without running stats (layer_norm)")

    marks = [i for i, op in enumerate(fwd_ops)
             if op.type == STAGE_BOUNDARY_OP]
    body_ops = [op for op in fwd_ops if op.type != STAGE_BOUNDARY_OP]
    # marker index i splits BEFORE the op that followed it; translate to
    # positions in the marker-free op list
    mark_cuts = [i - k for k, i in enumerate(marks)]
    if num_stages is None:
        if not marks:
            raise ValueError(
                "split_program: no stage_boundary() markers and no "
                "num_stages — nothing determines the cut points")
        cuts = mark_cuts
    elif marks and len(marks) == num_stages - 1:
        cuts = mark_cuts
    else:
        if num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        if num_stages > len(body_ops):
            raise ValueError(
                f"num_stages={num_stages} exceeds the {len(body_ops)} "
                "forward ops available to split")
        costs = [_op_cost(op, block) for op in body_ops]
        cuts = _balanced_cuts(costs, num_stages)
        cuts = _narrow_cuts(body_ops, costs, cuts, persist, set(),
                            program, block)
    bounds = [0] + list(cuts) + [len(body_ops)]
    if any(b >= e for b, e in zip(bounds, bounds[1:])):
        raise ValueError(
            f"degenerate partition {bounds}: every stage needs at least "
            "one op (fewer stages, or move the markers)")
    spans = [body_ops[b:e] for b, e in zip(bounds, bounds[1:])]
    k = len(spans)

    # ---- dataflow contract (the _prune_for_inference walk, applied to
    # stage spans): names produced strictly before a cut and consumed at
    # or after it must cross that boundary -------------------------------
    feed_like = {
        n for n, v in block.vars.items()
        if not v.persistable and v.op is None
    }
    produced_by_stage: List[set] = []
    seen: set = set()
    for span in spans:
        out = set()
        for op in span:
            out.update(op.output_names())
        produced_by_stage.append(out)
        seen |= out
    consumed_by_stage: List[set] = []
    for span in spans:
        local_prod: set = set()
        need: set = set()
        for op in span:
            need.update(n for n in op.input_names() if n not in local_prod)
            need.update(_sub_block_refs(program, op))
            local_prod.update(op.output_names())
        consumed_by_stage.append(need)

    produced_upto: set = set()
    stages: List[Stage] = []
    prev_out: Tuple[str, ...] = ()
    for s, span in enumerate(spans):
        produced_upto |= produced_by_stage[s]
        needed_after: set = set()
        for t in range(s + 1, k):
            needed_after |= consumed_by_stage[t]
        out_names = tuple(sorted(
            n for n in (produced_upto & needed_after)
            if n not in persist and n not in feed_like
        )) if s < k - 1 else ()
        feed_names = tuple(sorted(
            n for n in consumed_by_stage[s] if n in feed_like))
        state_names = tuple(sorted(
            n for n in consumed_by_stage[s] if n in persist))
        stages.append(Stage(
            index=s, ops=list(span),
            in_names=prev_out, out_names=out_names,
            feed_names=feed_names, state_names=state_names,
            cost=sum(_op_cost(op, block) for op in span),
        ))
        prev_out = out_names

    # collectible targets (loss + fetches) must be forward-produced; a
    # feed or persistable fetch has no per-microbatch schedule meaning
    for t in list(extra_targets) + [loss_name]:
        if t in persist:
            continue  # read from state, identical every microbatch
        if not any(t in p for p in produced_by_stage):
            raise ValueError(
                f"pipeline target {t!r} is not produced by the forward "
                "ops — fetch forward activations or persistables")

    # tail ops may read forward values (beyond grads/persistables):
    # those are averaged over microbatches, so they must be scalars
    grads = {f"{p}@GRAD" for p in param_names}
    tail_prod: set = set()
    tail_fwd: set = set()
    for op in tail_ops:
        for n in op.input_names():
            if (n in persist or n in grads or n in tail_prod
                    or n in feed_like):
                continue
            if any(n in p for p in produced_by_stage):
                tail_fwd.add(n)
        tail_prod.update(op.output_names())
    for n in sorted(tail_fwd):
        v = _var_or_none(block, n)
        if v is not None and v.shape and any(int(d) > 1 for d in v.shape):
            raise NotImplementedError(
                f"pipeline: optimizer-tail op reads non-scalar forward "
                f"value {n!r} (shape {v.shape}) — only scalar forward "
                "reads (losses) can be averaged across microbatches")

    return StagedProgram(
        program=program,
        stages=stages,
        loss_name=loss_name,
        param_names=param_names,
        tail_ops=list(tail_ops),
        tail_fwd_names=tuple(sorted(tail_fwd)),
        costs=[st.cost for st in stages],
    )


def _sub_block_refs(program: Program, op: Operator) -> set:
    """Names an op's sub-block(s) read from the enclosing scope — the
    same closure-reference walk io._prune_for_inference does, so a
    control-flow op's stage keeps every name its body consumes."""
    refs: set = set()
    idx = op.attrs.get("sub_block")
    if not isinstance(idx, int):
        return refs
    stack = [idx]
    while stack:
        b = program.blocks[stack.pop()]
        produced: set = set()
        for sop in b.ops:
            refs.update(n for n in sop.input_names() if n not in produced)
            produced.update(sop.output_names())
            inner = sop.attrs.get("sub_block")
            if isinstance(inner, int):
                stack.append(inner)
    return refs


def _var_or_none(block, name):
    try:
        return block.var(name)
    except KeyError:
        return None
