"""Data-parallel and tensor-parallel program execution
(paddle_tpu/parallel/data_parallel.py).

The reference sums gradients across replicas three ways (SURVEY.md §2.3):
MultiGradientMachine's ring between GPU threads
(MultiGradientMachine.h:63-110), the parameter servers' block-sharded SGD
(ParameterServer2.cpp:682,908) and the DistributeTranspiler's send/recv
rewrite (distribute_transpiler.py:77). The JAX package states it as one
sharding annotation that GSPMD lowers. Here the same Program runs in every
process of a `torch.distributed` group, and the executor adds what GSPMD
adds:

- **Feeds.** Every process passes the same global batch, as the JAX
  package's callers do (data_parallel.py:136-170); each rank of the `dp`
  axis keeps its rows. A ragged feed keeps whole sequences: rank i takes
  sequences [i·S/dp, (i+1)·S/dp) and their tokens, the last rank the
  batch's padding too, so the ranks' token rows partition the global
  batch's.
- **Gradients.** A rank's share of rows is not its share of the loss when
  feeds are ragged, so the reductions are weighted as the global
  computation weighs them: the loss's `mean` covers numel(X) elements on
  each rank, and the rank's gradients are scaled by numel_i / Σ numel
  before one all-reduce a dtype over `dp`, between the autodiff op and the
  optimizer ops. The fetched loss and `mean`/`accuracy` metrics are the
  same weighted sums; a non-scalar fetch is gathered along its rows.
  Every rank ends the step with the same bits.
- **ZeRO-1.** With `shard_optimizer_state=True` (data_parallel.py:65-74,
  87-107) each rank holds rows [i·n/dp, (i+1)·n/dp) of every optimizer
  accumulator whose first dimension divides by dp, and runs each
  optimizer op on those rows of its parameter and gradient; the updated
  rows are all-gathered into the whole parameter. The update is
  elementwise, so the parameters are the replicated run's bits.
- **Tensor parallelism.** A Variable's `.sharding` cuts it over a rank
  axis (`mp_axis` in models/transformer.py, parallel/sharded_embedding.py).
  A `mul` by a column-split weight gives this rank's output features (its
  input passes `copy_to_group`, whose backward all-reduces); the
  elementwise ops, activations and `flash_attention` (on this rank's heads)
  after it keep the features local; a `mul` by a row-split weight sums
  its partial products (`reduce_from_group`); any other op reading local
  features gets them all-gathered. A row-striped `lookup_table` looks up
  the ids in this rank's rows and all-reduces.
- **Seeds.** An unseeded startup and an unseeded run take the chief's
  seed (data_parallel.py:172-210), so every rank draws alike.

On the card the group is NCCL (gloo where several ranks share one card);
on the CPU, gloo. Without torch.distributed the executor runs one
process's whole batch, as the JAX package does on one chip.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.executor import BlockRunner, Executor, Scope, global_scope
from ..core.lod import LoDArray
from ..core.program import Program, default_main_program, grad_var_name
from ..core.sparse import SelectedRows, SparseArray
from . import distributed
from .collective import copy_to_group, gather_last, reduce_from_group
from .mesh import DP, local_slice, make_mesh, slice_owner

# ops that keep a tensor-parallel region's features local: elementwise on
# the last dimension, given their other inputs are local too or this
# rank's piece of a 1-D parameter
_LOCAL_ELEMENTWISE = frozenset({"elementwise_add", "elementwise_sub", "elementwise_mul",
                                "gelu", "relu", "tanh", "sigmoid", "scale"})


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _data(x):
    return x.data if isinstance(x, LoDArray) else x


def shard_lod(v: LoDArray, n: int, i: int) -> LoDArray:
    """Rank i's whole sequences of a ragged batch (the module docstring),
    on the host, as a LoDArray on v's device."""
    dev = v.device
    data, seq_ids, lengths, num_seqs = (t.cpu() for t in v.leaves()[:4])
    S = lengths.shape[0]
    if S % n:
        raise ValueError(f"ragged feed of {S} sequences is not divisible by dp={n}")
    lo, hi = i * S // n, (i + 1) * S // n
    offs = np.concatenate([[0], np.cumsum(lengths.numpy().astype(np.int64))])
    a = int(offs[lo])
    b = int(offs[hi]) if i < n - 1 else data.shape[0]
    ids = seq_ids[a:b]
    local = LoDArray(data[a:b], torch.where(ids >= 0, ids - lo, ids), lengths[lo:hi],
                     torch.clamp(num_seqs - lo, 0, hi - lo).to(num_seqs.dtype))
    if v.sub_seq_ids is not None:
        sub = v.sub_seq_ids.cpu()[a:b]
        first = int(sub[sub >= 0].min()) if bool((sub >= 0).any()) else 0
        local.sub_seq_ids = torch.where(sub >= 0, sub - first, sub)
    return local.to(dev)


def shard_rows(name: str, v, n: int, i: int, axis: str = DP):
    """Rank i's rows of a feed split n ways over `axis`: a dense value's
    rows [i·B/n, (i+1)·B/n), a ragged one's whole sequences (shard_lod); a
    0-d value whole."""
    if isinstance(v, LoDArray):
        return shard_lod(v, n, i)
    if isinstance(v, SparseArray):
        raise NotImplementedError(f"feed {name!r}: a sparse slot is not split over {axis} by "
                                  "the port's mesh executors")
    if getattr(v, "ndim", 0) == 0:
        return v
    if v.shape[0] % n:
        raise ValueError(f"feed {name!r}: batch dim {v.shape[0]} is not divisible by "
                         f"{axis}={n}")
    b = v.shape[0] // n
    return v[i * b:(i + 1) * b]


def scalar_weight(program: Program, name: str, env=None) -> float:
    """How many elements the fetched scalar `name` averages on this rank: a
    `mean`'s input's, an `accuracy`'s rows; 1.0 for either without `env`
    (ranks of equal rows, the pipeline's). Any other scalar raises: its
    combination across dp ranks is not known."""
    op = None
    for o in program.global_block().ops:
        if o.type == "autodiff":
            break
        if name in o.output_names():
            op = o
    if op is not None and op.type in ("mean", "accuracy"):
        if env is None:
            return 1.0
        if op.type == "mean":
            return float(_data(env[op.inputs["X"][0]]).numel())
        return float(env[op.inputs["Indices"][0]].shape[0])
    raise NotImplementedError(
        f"{name!r} (made by {op.type if op else 'no op'!r}) is a scalar whose combination "
        "across dp ranks the port does not know; fetch a `mean` or an `accuracy`, or the "
        "per-row values")


class DPReduction:
    """How a step's gradients and fetches combine over the n ranks of a dp
    group (the module docstring), for ParallelExecutor and the
    PipelineExecutor's dp axis alike: gradients scaled by this rank's share
    of the loss, then one all-reduce a dtype; a scalar fetch the same
    weighted sum; any other fetch gathered along its rows in rank order."""

    def __init__(self, group, n: int, device: torch.device):
        self.group, self.n, self.device = group, n, device

    def weights(self, w: float):
        """(this rank's weight, the sum over the group) as f32 0-d tensors."""
        w = torch.tensor(w, dtype=torch.float32, device=self.device)
        total = w.clone()
        _dist().all_reduce(total, group=self.group)
        return w, total

    def gradients(self, env, names, loss_weight: float) -> None:
        """Replace each gradient in `env` named in `names` by the global
        batch's: scaled by loss_weight / Σ loss_weight, then summed."""
        w, total = self.weights(loss_weight)
        scale = w / total
        by_dtype: Dict[torch.dtype, list] = {}
        for k in names:
            by_dtype.setdefault(env[k].dtype, []).append(k)
        for dtype, ks in by_dtype.items():
            gs = [env[k] for k in ks]
            flat = torch.cat([g.reshape(-1) for g in gs]) * scale.to(dtype)
            _dist().all_reduce(flat, group=self.group)
            for k, g, part in zip(ks, gs, flat.split([g.numel() for g in gs])):
                env[k] = part.view(g.shape)

    def fetch(self, v, weight):
        """A fetched value of the global batch: a scalar's weighted mean
        (`weight()` is this rank's weight, read only for a scalar), else the
        ranks' rows in rank order."""
        if v.numel() == 1:
            w, total = self.weights(weight())
            s = v.detach().float() * w
            _dist().all_reduce(s, group=self.group)
            return (s / total).to(v.dtype).reshape(v.shape)
        parts = [torch.empty_like(v) for _ in range(self.n)]
        _dist().all_gather(parts, v.detach().contiguous(), group=self.group)
        return torch.cat(parts, 0)


class _MeshRunner(BlockRunner):
    """The block runner of a tensor-parallel program: the ops the plan
    names take their collectives around the kernel (the module
    docstring); every other op runs as BlockRunner runs it."""

    def __init__(self, program, exe, plan):
        super().__init__(program)
        self.exe, self.plan = exe, plan

    def run_ops(self, ops, env, block, first: int = 0):
        for i, op in enumerate(ops, first):
            act = self.plan.get(id(op)) if block.idx == 0 else None
            if act is None:
                BlockRunner.run_ops(self, [op], env, block, first=i)
            else:
                self.exe._tensor_parallel_op(self, act, op, env, block, i)
        return env


class ParallelExecutor(Executor):
    """Executor over a Mesh: feeds split over `dp`, gradients all-reduced,
    parameters replicated unless a Variable's `.sharding` cuts them (the
    module docstring). `device` defaults to this rank's device
    (parallel/distributed.py)."""

    # the Trainer does not prefetch feeds this executor splits by rank, and
    # does not run its windows (paddle_tpu/trainer.py:705-718): its per-step
    # loop runs here, loudly
    prefetch_by_default = False
    device_metric_accumulation = False
    scan_window_supported = False

    def __init__(self, mesh=None, batch_axis: str = DP, shard_optimizer_state: bool = False,
                 device=None):
        super().__init__(device if device is not None else distributed.device())
        self.mesh = mesh or make_mesh()
        self.batch_axis = batch_axis
        self.shard_optimizer_state = shard_optimizer_state
        self._plans: Dict[Any, Any] = {}

    @property
    def _multiprocess(self) -> bool:
        return distributed.process_count() > 1

    # -- placements ------------------------------------------------------
    def _state_spec(self, program: Program, name: str):
        """(spec, from ZeRO) of a persistable: its `.sharding`, else the dp
        rows of a shardable optimizer accumulator, else (None, False)."""
        var = program.global_block().vars.get(name)
        if var is None:
            return None, False
        if var.sharding is not None:
            return tuple(var.sharding), False
        dp = self.mesh.size(self.batch_axis)
        if (self.shard_optimizer_state and var.is_optimizer_state and len(var.shape) >= 1
                and var.shape[0] != -1 and var.shape[0] % dp == 0):
            return (self.batch_axis,) + (None,) * (len(var.shape) - 1), True
        return None, False

    def _place_state(self, program: Program, scope: Scope) -> None:
        """Cut each whole persistable with a placement down to this rank's
        slice (after the startup, a resume, a reshard), noting the slice in
        `scope.shards` for the sharded checkpoint."""
        for v in program.persistables():
            if not scope.has(v.name) or v.name in scope.shards:
                continue
            spec, _ = self._state_spec(program, v.name)
            if spec is None or all(self.mesh.size(a) == 1 for a in spec if a is not None):
                continue
            val = scope.get(v.name)
            if tuple(val.shape) != tuple(v.shape):
                raise ValueError(f"{v.name!r}: scope value of shape {tuple(val.shape)} is "
                                 f"neither the whole {tuple(v.shape)} nor a slice this "
                                 "executor made")
            sl = local_slice(self.mesh, spec, tuple(val.shape))
            scope.set(v.name, val[tuple(slice(a, b) for a, b in sl)].clone())
            scope.shards[v.name] = {"shape": list(val.shape), "slice": sl,
                                    "owner": slice_owner(self.mesh, spec)}

    def _shard_feed(self, name: str, v):
        n = self.mesh.size(self.batch_axis)
        if n == 1:
            return v
        return shard_rows(name, v, n, self.mesh.axis_index(self.batch_axis), self.batch_axis)

    # -- runs ------------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed=None, fetch_list=None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            seed: Optional[int] = None):
        """A startup-style program (it makes persistables the scope lacks,
        with no feed and no fetch) runs as run_startup; any other runs on
        this rank's rows (the module docstring)."""
        prog = program or default_main_program()
        scope_ = scope or global_scope()
        creates_new = any(not scope_.has(v.name) for v in prog.persistables())
        if creates_new and not feed and not fetch_list:
            return self.run_startup(prog, scope=scope_, seed=seed)
        if self.mesh.size(self.batch_axis) > 1:
            self._refuse_batch_statistics(prog)
        self._place_state(prog, scope_)
        local = {k: self._shard_feed(k, v) for k, v in (feed or {}).items()}
        if seed is None and not prog.random_seed:
            seed = self._draw_seed(prog)
        return super().run(prog, local, fetch_list, scope_, return_numpy, seed)

    @staticmethod
    def _refuse_batch_statistics(program: Program) -> None:
        """Statistics over the batch in training (batch_norm's, the fused
        conv's, bn_stats') would be each rank's, not the global batch's as
        in the JAX package: refused, not computed per rank."""
        ops = sorted({o.type for o in program.global_block().ops
                      if o.type in ("batch_norm", "bn_stats", "fused_conv_bn")
                      and not o.attrs.get("is_test", False)})
        if ops:
            raise NotImplementedError(
                f"ParallelExecutor: {ops} compute statistics over the batch in training; "
                "their all-reduce over dp (sync batch norm) is not ported")

    def run_startup(self, program: Program, scope: Optional[Scope] = None,
                    seed: Optional[int] = None):
        """The init program, whole, on every rank: an unseeded one takes one
        seed from the chief, so every rank makes the same values."""
        if seed is None and self._multiprocess and not program.random_seed:
            seed = distributed.broadcast_int(int.from_bytes(os.urandom(4), "little") % (2**31 - 1))
        return Executor.run(self, program, scope=scope, seed=seed)

    def _draw_seed(self, program: Program) -> Optional[int]:
        """The chief's base once, then a local counter: every rank calls run
        in lockstep, so the sequence stays aligned without a collective a
        step (data_parallel.py:195-210)."""
        if not self._multiprocess or program.random_seed:
            return None
        if not hasattr(self, "_seed_base"):
            self._seed_base = distributed.broadcast_int(int.from_bytes(os.urandom(4), "little")
                                                  % (2**30))
            self._seed_calls = 0
        self._seed_calls += 1
        return (self._seed_base + self._seed_calls) % (2**31 - 1)

    # -- the reductions (DPReduction) -------------------------------------
    def _dp_group(self):
        return self.mesh.group(self.batch_axis)

    def _reduces(self) -> bool:
        """Whether gradients and fetches are reduced over a dp group."""
        return _dist() is not None and self.batch_axis in self.mesh.shape

    def _reduction(self) -> DPReduction:
        return DPReduction(self._dp_group(), self.mesh.size(self.batch_axis), self.device)

    def _after_autodiff(self, program: Program, op, env) -> None:
        if not self._reduces():
            return
        names = []
        for p in op.attrs["params"]:
            g = env.get(grad_var_name(p))
            if g is None:
                continue
            if isinstance(g, SelectedRows):
                raise NotImplementedError(
                    f"ParallelExecutor: {p!r} takes SelectedRows gradients (is_sparse); their "
                    "all-reduce is not ported — build the table with is_sparse=False")
            names.append(grad_var_name(p))
        loss = op.inputs["Loss"][0]
        self._reduction().gradients(env, names, scalar_weight(program, loss, env))

    def _fetch_values(self, program: Program, env, fetch_names) -> list:
        out = []
        persist = {v.name for v in program.persistables()}
        plan = self._plan(program)
        for n in fetch_names:
            v = env[n]
            if _dist() is None or n in persist:
                out.append(v)
                continue
            if n in plan.get("@local@", {}):
                ax = plan["@local@"][n]
                v = gather_last(v.detach(), self.mesh.group(ax), self.mesh.size(ax),
                                self.mesh.axis_index(ax))
            if not self._reduces():
                out.append(v)
                continue
            if isinstance(v, LoDArray):
                raise NotImplementedError(f"ParallelExecutor: fetching the ragged {n!r} across "
                                          "dp ranks is not ported")
            out.append(self._reduction().fetch(v, lambda: scalar_weight(program, n, env)))
        return out

    # -- ZeRO-1 ------------------------------------------------------------
    def _run_tail(self, runner, ops, env, block, first: int) -> None:
        program = runner.program
        for i, op in enumerate(ops, first):
            zero = [n for n in op.input_names()
                    if op.attrs.get("is_optimizer_op") and self._state_spec(program, n)[1]
                    and self.mesh.size(self.batch_axis) > 1]
            if not zero:
                runner.run_ops([op], env, block, first=i)
                continue
            p, g = op.inputs["Param"][0], op.inputs["Grad"][0]
            full_p, full_g = env[p], env[g]
            if isinstance(full_g, SelectedRows):
                raise NotImplementedError(f"ZeRO-1: {p!r} takes SelectedRows gradients")
            dp = self.mesh.size(self.batch_axis)
            rows = full_p.shape[0] // dp
            r0 = self.mesh.axis_index(self.batch_axis) * rows
            env[p], env[g] = full_p[r0:r0 + rows], full_g[r0:r0 + rows]
            runner.run_ops([op], env, block, first=i)
            parts = [torch.empty_like(env[p]) for _ in range(dp)]
            _dist().all_gather(parts, env[p].contiguous(), group=self._dp_group())
            env[p] = torch.cat(parts, 0)
            for out in op.outputs.get("ParamOut", []):
                env[out] = env[p]
            env[g] = full_g

    # -- tensor parallelism ----------------------------------------------
    def _runner(self, program: Program) -> BlockRunner:
        plan = self._plan(program)
        return _MeshRunner(program, self, plan) if plan else BlockRunner(program)

    def _plan(self, program: Program) -> Dict[Any, Any]:
        """{id(op): action} for the ops a tensor-parallel placement touches,
        and "@local@": {name: axis} of the values holding this rank's
        features (the module docstring); {} when nothing is cut."""
        key = (id(program), program.version)
        hit = self._plans.get(key)
        if hit is not None:
            return hit[1]
        gb = program.global_block()

        def spec(n):
            v = gb.vars.get(n)
            s = tuple(v.sharding) if v is not None and v.sharding is not None else ()
            return tuple(a if a is not None and self.mesh.size(a) > 1 else None for a in s)

        plan: Dict[Any, Any] = {}
        local: Dict[str, str] = {}
        for op in gb.ops:
            if op.type == "autodiff":
                break
            if op.type == "mul" and any(spec(op.inputs["Y"][0])):
                ys = spec(op.inputs["Y"][0])
                x = op.inputs["X"][0]
                if ys[-1] is not None:  # column split: local output features
                    plan[id(op)] = ("col", ys[-1], None)
                    for n in op.output_names():
                        local[n] = ys[-1]
                elif x in local:  # row split of local features: partial sums
                    plan[id(op)] = ("row", ys[0], None)
                else:
                    raise NotImplementedError(
                        f"tensor parallel: {op.inputs['Y'][0]!r} is split by rows but its "
                        f"input {x!r} is whole; split the product before it by columns "
                        "(and its bias with it, as mp_axis does)")
                continue
            if op.type == "lookup_table" and any(spec(op.inputs["W"][0])):
                plan[id(op)] = ("embed", spec(op.inputs["W"][0])[0], None)
                continue
            ins = [n for n in op.input_names() if n in local]
            if not ins:
                continue
            ax = local[ins[0]]
            others = [n for n in op.input_names() if n not in local]
            if op.type == "flash_attention":
                plan[id(op)] = ("heads", ax, None)
            elif op.type in _LOCAL_ELEMENTWISE and all(spec(n) == (ax,) for n in others):
                pass
            else:
                plan[id(op)] = ("gather", ax, tuple(ins))
                continue
            for n in op.output_names():
                local[n] = ax
        if plan:
            plan["@local@"] = local
        self._plans[key] = (program, plan)
        return plan

    def _tensor_parallel_op(self, runner, act, op, env, block, i) -> None:
        kind, ax, extra = act
        group, n, idx = self.mesh.group(ax), self.mesh.size(ax), self.mesh.axis_index(ax)

        def on_data(v, fn):
            return v.with_data(fn(v.data)) if isinstance(v, LoDArray) else fn(v)

        def run_with(bound):
            """Run `op` with some inputs bound anew, then bind them back."""
            saved = {nm: env[nm] for nm in bound}
            env.update(bound)
            try:
                BlockRunner.run_ops(runner, [op], env, block, first=i)
            finally:
                for nm, v in saved.items():
                    if nm not in op.output_names():
                        env[nm] = v

        if kind == "col":  # a whole input whose gradient each rank holds a part of
            x = op.inputs["X"][0]
            run_with({x: on_data(env[x], lambda t: copy_to_group(t, group))})
        elif kind == "row":
            BlockRunner.run_ops(runner, [op], env, block, first=i)
            out = op.outputs["Out"][0]
            env[out] = on_data(env[out], lambda t: reduce_from_group(t, group))
        elif kind == "embed":
            self._sharded_lookup(op, env, group, n, idx)
        elif kind == "heads":
            q = env[op.inputs["Q"][0]]
            full = runner.program.global_block().var(op.inputs["Q"][0]).shape[-1]
            heads = op.attrs["num_heads"] * q.shape[-1] // full
            local_op = type(op)(op.type, op.inputs, op.outputs, dict(op.attrs, num_heads=heads))
            BlockRunner.run_ops(runner, [local_op], env, block, first=i)
        else:  # gather the local features an op needs whole
            run_with({nm: on_data(env[nm], lambda t: gather_last(t, group, n, idx))
                      for nm in extra})

    @staticmethod
    def _sharded_lookup(op, env, group, n, idx) -> None:
        """Each id in this rank's rows looked up here, zeros elsewhere, then
        the sum over the axis (sharded_embedding.py)."""
        w = env[op.inputs["W"][0]]
        ids = env[op.inputs["Ids"][0]]
        data = _data(ids)
        if data.dim() > 1 and data.shape[-1] == 1:
            data = data[..., 0]
        rows = w.shape[0]
        local_ids = data.long() - idx * rows
        inside = (local_ids >= 0) & (local_ids < rows)
        out = w[torch.where(inside, local_ids, 0)]
        zero = torch.zeros((), dtype=out.dtype, device=out.device)
        out = torch.where(inside[..., None], out, zero)
        pad = op.attrs.get("padding_idx")
        if pad is not None:
            out = torch.where((data == pad)[..., None], zero, out)
        out = reduce_from_group(out, group)
        env[op.outputs["Out"][0]] = ids.with_data(out) if isinstance(ids, LoDArray) else out
