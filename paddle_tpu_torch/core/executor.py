"""Executor: run a Program's global block op by op on torch tensors.

The JAX package traces the block into one jitted XLA program per feed
signature (paddle_tpu/core/executor.py). PyTorch runs eagerly, so the port
walks the ops in order with no trace and no cache — the imperative
semantics the reference executor (paddle/framework/executor.cc:117-146)
has. Persistable values (parameters, optimizer state) live in a Scope
across runs; every persistable an op replaced is written back after the
run, as the JAX package's `new_state` is.

A block with an `autodiff` op (what `append_backward` inserts) trains: the
ops before it run once with autograd recording, each parameter the op
names being a leaf that requires grad; at the op, `torch.autograd.grad`
writes `P@GRAD` for every parameter; the ops after it (the optimizer
updates) run under `torch.no_grad()`. The JAX package instead wraps the
forward slice in `jax.grad` (`_run_autodiff`, executor.py:187-228); the
forward is not run a second time here. A block without `autodiff` runs
under `torch.inference_mode()`. A parameter marked `sparse_update` (an
`is_sparse` embedding) is no leaf: its lookup sites gather leaves of their
own rows, and its gradient is a `SelectedRows` (core/sparse.py). Under
`memory_optimize(program, policy)` the forward runs as checkpointed
segments that the backward recomputes (core/remat.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..amp import AMP_KEY
from . import registry
from .lod import LoDArray
from .place import resolve_device
from .program import Program, Variable, default_main_program, grad_var_name
from .remat import REMAT_POLICIES, run_forward
from .sparse import SparseArray, SparseGradTape, feed_leaves

# the policies memory_optimize takes (paddle_tpu/core/executor.py:38): what
# each keeps of the forward is core/remat.py's
_REMAT_POLICIES = REMAT_POLICIES


def memory_optimize(program: Optional[Program] = None, policy: str = "dots") -> None:
    """Rematerialize the program's forward in its backward pass under
    `policy` (paddle_tpu/core/executor.py:45): "full" keeps nothing of the
    forward, "dots" the products' and convolutions' outputs,
    "dots_no_batch" the products' without batch dimensions."""
    program = program or default_main_program()
    if policy not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; choose from "
                         f"{sorted(_REMAT_POLICIES)}")
    program.remat_policy = policy


class Scope:
    """name → runtime value store."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}

    def set(self, name: str, value) -> None:
        self.vars[name] = value

    def get(self, name: str):
        return self.vars[name]

    def has(self, name: str) -> bool:
        return name in self.vars

    def keys(self):
        return self.vars.keys()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope() -> None:
    global _global_scope
    _global_scope = Scope()


def accum_fold(state, cost, metrics: Sequence, skip_nonfinite: bool):
    """One on-device fold of a step's cost and metrics into the pass's
    accumulator (paddle_tpu/core/executor.py:112), as torch operations on
    the accumulator's device with no host read.

    state: (n_good, cost_sum, [metric_sums...], n_bad), int32/float32
    0-d tensors. skip_nonfinite (a StepGuard is armed) gates a non-finite
    step's cost and metrics out of the sums; n_bad is what the guard reads
    on its sync cadence."""
    n, cost_sum, metric_sums, bad = state
    c = torch.as_tensor(cost).reshape(()).to(torch.float32)
    finite = torch.isfinite(c)
    good = finite if skip_nonfinite else torch.ones((), dtype=torch.bool, device=c.device)
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    n = n + good.to(torch.int32)
    cost_sum = cost_sum + torch.where(good, c, zero)
    metric_sums = [m + torch.where(good, torch.as_tensor(v).reshape(()).to(torch.float32),
                                   zero)
                   for m, v in zip(metric_sums, metrics)]
    bad = bad + (~finite).to(torch.int32)
    return n, cost_sum, metric_sums, bad


def _feed_signature(feed: Dict[str, Any]):
    """(name, kind, ((shape, dtype), ...)) for each feed slot in name
    order: equal signatures take the same shapes through the program
    (paddle_tpu/core/executor.py:137). A dense slot (a numpy array or a
    tensor) has one leaf; a LoDArray's are its data, seq_ids, lengths and
    num_seqs; a SparseArray's its indices, values and rowids, and its kind
    holds its batch and dim."""
    sig = []
    for k in sorted(feed):
        v = feed[k]
        if isinstance(v, LoDArray):
            kind = "lod"
        elif isinstance(v, SparseArray):
            kind = ("sparse", v.batch, v.dim)
        else:
            kind = "dense"
        leaves = feed_leaves(v)
        sig.append((k, kind,
                    tuple((tuple(l.shape), str(l.dtype).replace("torch.", ""))
                          for l in leaves)))
    return tuple(sig)


def _detach(v):
    if isinstance(v, LoDArray):
        return v.with_data(v.data.detach())
    return v.detach() if isinstance(v, torch.Tensor) else v


def _to_numpy(v):
    if isinstance(v, LoDArray):
        return v
    if v.dtype == torch.bfloat16:  # numpy has no bfloat16
        v = v.float()
    return v.cpu().numpy()


def _grad_leaf(name, value):
    """A parameter as a leaf that requires grad. A value made under
    inference_mode (a startup program's output) cannot record autograd, so
    it is copied once; later steps find the optimizer's ordinary tensors."""
    if not isinstance(value, torch.Tensor):
        raise TypeError(f"autodiff: parameter {name!r} is a "
                        f"{type(value).__name__}, not a tensor")
    leaf = value.clone() if value.is_inference() else value.detach()
    return leaf.requires_grad_(True)


class BlockRunner:
    """Runs a block's ops on an env (paddle_tpu/core/executor.py
    `_BlockRunner.run_ops`, :152-181): the Executor's walk over block 0, and
    the one a control-flow kernel takes over its sub-block (`ctx.executor`).
    The env carries what the caller sets: the amp dtype (`@AMP@`), the random
    ops' generator (`@RNG@`) and the values the ops close over. It reads
    nothing back to the host, so a captured step may call it
    (serving/scheduler.py). A failing op is named with its block, as the
    JAX runner names it."""

    def __init__(self, program: Program):
        self.program = program

    def run_ops(self, ops, env: Dict[str, Any], block, first: int = 0):
        for i, op in enumerate(ops, first):
            kernel = registry.get_kernel(op.type)
            try:
                kernel(registry.OpContext(op, env, executor=self))
            except Exception as e:
                raise RuntimeError(
                    f"{e}\n  while executing op #{i} {op.type!r} (block {block.idx}) "
                    f"inputs={op.inputs} outputs={op.outputs}") from e
        return env


class Executor:
    """`Executor(device).run(program, feed, fetch_list, scope)`.

    `device=None` is the card; the CPU runs only when named (core/place.py).
    `run_window` runs a window of training steps (the Trainer's
    scan_window); its captured steps are held in `_windows`, counted in
    `cache_stats`.
    """

    # the Trainer's scan_window runs here (paddle_tpu/trainer.py:703)
    scan_window_supported = True

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._windows: Dict[tuple, Any] = {}  # run_window's steps by key
        self.cache_stats = {"hits": 0, "misses": 0, "captures": 0, "replays": 0,
                            "eager_steps": 0}
        if self.device.type == "cuda":
            # bf16 GEMMs must reduce in f32, as the JAX package's
            # preferred_element_type=f32 does (ops/math_ops.dot); cuBLAS
            # may otherwise reduce split-K partial sums in bf16
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            # and f32 convolutions multiply in f32, where torch's default
            # lets cuDNN round their operands to TF32 (ops/nn_ops.conv2d);
            # f32 GEMMs already do (matmul.allow_tf32 defaults to False)
            torch.backends.cudnn.allow_tf32 = False

    def _to_device(self, name, v):
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v, device=self.device)
        if isinstance(v, (torch.Tensor, LoDArray, SparseArray)):
            return v.to(self.device)
        raise TypeError(f"feed {name!r}: expected a numpy array, a tensor, a LoDArray "
                        f"or a SparseArray, got {type(v).__name__}")

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        """The random ops' generator for one run: from `seed`, else a fresh
        seed, as the JAX package draws one (executor.py `_draw_seed`); the
        caller passes the program's random_seed when it is set."""
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def run(
        self,
        program: Program,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        seed: Optional[int] = None,
    ):
        """Runs the global block; returns the fetches (numpy unless
        return_numpy=False). `seed` seeds the random ops of this run
        (default: a fresh seed)."""
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        env: Dict[str, Any] = {}
        persist = [v.name for v in program.persistables()]
        for name in persist:
            if scope.has(name):
                val = scope.get(name)
                if val.device != self.device:
                    raise ValueError(
                        f"scope value {name!r} lies on {val.device}, the "
                        f"executor runs on {self.device}: load the "
                        "parameters onto the executor's device")
                env[name] = val
        for k, v in (feed or {}).items():
            env[k] = self._to_device(k, v)
        gen = self._generator(seed if seed is not None else program.random_seed or None)
        self._execute(program, env, fetch_names, persist, gen)
        for name in persist:
            if name in env:
                scope.set(name, _detach(env[name]))
        fetches = [_detach(env[n]) for n in fetch_names]
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        return fetches

    def _execute(self, program: Program, env: Dict[str, Any], fetch_names, persist,
                 gen: torch.Generator) -> None:
        """The block's ops on `env` (the persistables and the feeds), with
        `gen` for the random ops: a block with an `autodiff` op trains, one
        without runs under inference_mode (the module docstring)."""
        env[AMP_KEY] = program.amp_dtype
        env[registry.RNG_KEY] = gen
        env[registry.PROGRAM_KEY] = program
        block = program.global_block()
        ops = block.ops
        # a sub-block's ops read the enclosing block's values too
        env[registry.LIVE_KEY] = {n for b in program.blocks for op in b.ops
                                  for names in op.inputs.values()
                                  for n in names} | set(fetch_names) | set(persist)
        runner = BlockRunner(program)
        at = [i for i, op in enumerate(ops) if op.type == "autodiff"]
        if not at:
            with torch.inference_mode():
                runner.run_ops(ops, env, block)
        elif len(at) > 1:
            raise NotImplementedError(
                f"{len(at)} autodiff ops in one block: the port runs one")
        else:
            k = at[0]
            leaves, tape = self._grad_leaves(program, ops[k], env)
            if tape is not None:
                env[registry.SPARSE_KEY] = tape
            with torch.enable_grad():
                if program.remat_policy:
                    read_after = {n for op in ops[k:] for names in op.inputs.values()
                                  for n in names} | set(fetch_names) | set(persist)
                    run_forward(runner, ops[:k], env, block, program.remat_policy,
                                read_after)
                else:
                    runner.run_ops(ops[:k], env, block)
                self._run_autodiff(ops[k], env, leaves, env.pop(registry.SPARSE_KEY, None))
            with torch.no_grad():
                runner.run_ops(ops[k + 1:], env, block, first=k + 1)

    def run_window(self, program: Program, feed: Dict[str, Any],
                   fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
                   acc_state=None, skip_nonfinite: bool = False):
        """K training steps, the feeds stacked on a leading window axis
        (`data.feeder.FeedWindow`), in one host dispatch: on the card one
        captured step replayed K times (core/graph.py), on the CPU K eager
        steps on the same buffers. `acc_state`, when given, is the
        `accum_fold` accumulator, folded inside each step (fetch_list[0] is
        the cost). Returns (ys, acc_out): ys aligned with fetch_list, each
        with a leading axis of K, still on the device; the scope holds the
        window's persistable buffers after it."""
        from . import graph

        return graph.run_window(self, program, feed, fetch_list, scope or global_scope(),
                                acc_state, skip_nonfinite)

    def run_startup(self, program: Program, scope: Optional[Scope] = None,
                    seed: Optional[int] = None):
        """Run a startup (init) program (paddle_tpu/core/executor.py:474):
        the same as run() here, where one device holds every value."""
        return self.run(program, scope=scope, seed=seed)

    @staticmethod
    def _grad_leaves(program: Program, op, env):
        """Replace each dense parameter the autodiff op names with a leaf
        that requires grad, before the forward ops read it. Returns the
        leaves and, where sparse_update parameters are among them, the tape
        their lookup sites record on (else None)."""
        block = program.global_block()
        sparse = [p for p in op.attrs["params"]
                  if p in block.vars and block.vars[p].sparse_update]
        leaves = {}
        for p in op.attrs["params"]:
            if p not in env:
                raise KeyError(f"autodiff: parameter {p!r} is not in the scope; "
                               "run the startup program first")
            if p not in sparse:
                leaves[p] = env[p] = _grad_leaf(p, env[p])
        if not sparse:
            return leaves, None
        # a sparse table read by any other op would get no gradient from it
        for o in block.ops:
            if o.type in ("lookup_table", "autodiff") or o.attrs.get("is_optimizer_op"):
                continue
            used = sorted({n for ns in o.inputs.values() for n in ns} & set(sparse))
            if used:
                raise ValueError(
                    f"sparse_update parameters {used} consumed by op {o.type!r}: "
                    "SelectedRows gradients support lookup_table uses only; build the "
                    "embedding with is_sparse=False for a tied or shared weight")
        return leaves, SparseGradTape(sparse)

    @staticmethod
    def _run_autodiff(op, env, leaves, tape=None) -> None:
        loss_name = op.inputs["Loss"][0]
        loss = env[loss_name]
        if loss.numel() != 1:
            raise ValueError(f"loss {loss_name!r} must be scalar for "
                             f"append_backward; got shape {tuple(loss.shape)}")
        names = [p for p in op.attrs["params"] if p in leaves]
        sites = tape.leaves() if tape is not None else []
        grads = torch.autograd.grad(loss.reshape(()), [leaves[p] for p in names] + sites,
                                    allow_unused=True)
        for p, g in zip(names, grads):
            env[grad_var_name(p)] = torch.zeros_like(leaves[p]) if g is None else g
        if tape is not None:
            for p, g in tape.gradients(grads[len(names):]).items():
                env[grad_var_name(p)] = g
