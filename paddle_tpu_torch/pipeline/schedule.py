"""The GPipe micro-batch schedule (paddle_tpu/pipeline/schedule.py).

The JAX package runs the stage grid of GPipe (Huang et al.; PAPERS.md) as
one jitted `lax.scan` over T = M + K - 1 ticks: at tick t stage s works on
micro-batch m = t - s, the cells outside [0, M) masked (the fill and drain
bubbles), and `jax.value_and_grad` through the scan is the backward drain.
Here the ticks are a Python loop of eager stage runs; a bubble cell runs
nothing (the JAX package masks it only because a static scan must run it).

- **Forward.** At tick t, for s = 0..K-1, stage s runs its ops on
  micro-batch t - s: its feed rows, the scope's state on its device, and
  the values the boundary before it carries, detached there so that each
  stage's backward is its own. A boundary moves to the next stage's device
  with `.to(device, non_blocking=True)` (on one card every stage is on
  it).
- **Backward drain.** The ticks again in reverse, for s = K-1..0: stage s's
  outputs for micro-batch m take the gradients the next stage handed back
  (and the last stage's loss its seed 1/M, as d mean/d loss_m), and
  `torch.autograd.grad` gives the stage's parameter gradients and its
  boundary inputs' gradients. A parameter's contributions are added in one
  order, m = M-1 down to 0, for every K.
- **1F1B.** `schedule="1f1b"` runs each stage's forward as
  core/remat.py's checkpointed segments (its ops that draw, `runs_once`,
  between them, never recomputed), so the drain recomputes a stage's
  forward instead of holding M activation sets: GPipe's order with
  1F1B's peak memory, as in the JAX package.
- **Draws.** Micro-batch m draws from a generator of its own, seeded from
  the step's seed and m, so a draw is keyed by (micro-batch, its op's
  place in the forward) whatever the stage count. The optimizer ops draw
  from the step's generator.
- **Tail.** The ops after the autodiff op run once, on the micro-batch
  mean of the loss (summed in f32 in micro-batch order, as the JAX scan
  carry sums it) and the summed gradients: gradient accumulation.

Determinism contract (schedule.py:20-44): for a fixed M, the parameters
after a step are bit-identical for every K, in both schedules. Each
micro-batch runs the same kernels on the same inputs whatever K is, eager
torch fuses nothing across a cut, and the sums above have one order. A
boundary value read at both sides of a cut gets its gradient as the sum
of the two sides' parts, which is the unstaged sum's two terms (a + b ==
b + a); a parameter read in two stages (a tied weight split by a user
marker) adds its parts in another order and voids the guarantee, as in
the JAX package. The tick loop reads nothing back to the host, so a
window (core/graph.py) captures the whole staged step as one CUDA graph.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List

import torch

from ..amp import AMP_KEY
from ..core import registry
from ..core.executor import Executor
from ..core.lod import LoDArray
from ..core.program import Program, grad_var_name
from ..core.remat import run_forward
from ..parallel.data_parallel import DPReduction, scalar_weight, shard_rows
from .partition import StagedProgram, split_program

SCHEDULES = ("gpipe", "1f1b")


def microbatch_seed(seed: int, m: int) -> int:
    """Micro-batch m's generator seed, from the step's."""
    return (int(seed) * 0x9E3779B1 + 2 * m + 1) % (2**63 - 1)


class PipelineExecutor(Executor):
    """Executor that runs training programs as a K-stage, M-micro-batch
    pipeline, with the base Executor's `run()` and `run_window()` (a window
    replays the whole staged step as one captured graph). Programs without
    an `autodiff` op (startup, inference) run unstaged.

    `mesh`: its `pp` axis's devices take the stages (`mesh.pp_devices`, K
    divisible by pp, stage s on device s·pp/K; without one every stage
    runs on the executor's device), and its `dp` axis's ranks each
    pipeline their rows of the global batch (`run`). `place` is the
    executor's device (the card unless "cpu" is named)."""

    def __init__(self, place=None, num_stages: int = 2, num_microbatches: int = 4,
                 mesh=None, schedule: str = "gpipe", donate_state: bool = False):
        super().__init__(place)
        if int(num_stages) < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        if int(num_microbatches) < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}; choose from "
                             f"{SCHEDULES}")
        if donate_state:
            raise ValueError("donate_state: an eager step replaces its state tensors; "
                             "there are no buffers to donate")
        self.num_stages = int(num_stages)
        self.num_microbatches = int(num_microbatches)
        self.mesh = mesh
        self.schedule = schedule
        self._partitions: Dict[Any, Any] = {}
        self._dispatched = False
        pp = mesh.shape.get("pp", 1) if mesh is not None else 1
        if pp > 1 and self.num_stages % pp:
            raise ValueError(
                f"num_stages={self.num_stages} is not divisible by the mesh pp axis ({pp}) "
                "— stages cannot be laid out on the pp slices")
        if mesh is not None:
            # as the JAX package's: the Trainer neither prefetches to one
            # device nor runs windows for a mesh pipeline (its loud fallback)
            self.prefetch_by_default = False
            self.device_metric_accumulation = False
            self.scan_window_supported = False
        self.stage_devices = [
            mesh.pp_devices[s * pp // self.num_stages]
            if mesh is not None and mesh.pp_devices else self.device
            for s in range(self.num_stages)]
        # one generator a micro-batch (the module docstring), on the
        # executor's device
        self._mb_gens = [torch.Generator(device=self.device)
                         for _ in range(self.num_microbatches)]
        _register_pipeline_metrics(self)

    # -- a dp axis: each rank pipelines its rows of the global batch ------
    def _dp_group_size(self) -> int:
        import torch.distributed as dist

        if self.mesh is None or not (dist.is_available() and dist.is_initialized()):
            return 1
        return self.mesh.shape.get("dp", 1)

    def run(self, program, feed=None, fetch_list=None, scope=None, return_numpy=True,
            seed=None):
        """Executor.run; with a mesh's dp axis of n ranks, each rank keeps its
        1/n of the global batch's rows (the same global batch on every rank,
        as parallel.ParallelExecutor takes it), and the step's gradients and
        fetches are the global batch's."""
        n = self._dp_group_size()
        if n > 1 and feed:
            i = self.mesh.axis_index("dp")
            feed = {k: shard_rows(k, v, n, i, "dp") for k, v in feed.items()}
        return super().run(program, feed, fetch_list, scope, return_numpy, seed)

    def _reduction(self) -> DPReduction:
        return DPReduction(self.mesh.group("dp"), self.mesh.shape["dp"], self.device)

    def _fetch_values(self, program, env, fetch_names) -> list:
        """With a dp axis, the fetches of the global batch, combined as
        ParallelExecutor combines them (parallel/data_parallel.py); every
        rank holds equal rows, so a `mean` weighs alike on each."""
        vals = super()._fetch_values(program, env, fetch_names)
        if self._dp_group_size() <= 1:
            return vals
        red, persist = self._reduction(), {v.name for v in program.persistables()}
        return [v if n in persist else red.fetch(v, lambda n=n: scalar_weight(program, n))
                for n, v in zip(fetch_names, vals)]

    # -- executor hooks --------------------------------------------------
    def _step_generators(self) -> tuple:
        return tuple(self._mb_gens)

    def _seed_step_generators(self, seed: int) -> None:
        for m, g in enumerate(self._mb_gens):
            g.manual_seed(microbatch_seed(seed, m))

    def _staged(self, program: Program, fetch_names) -> StagedProgram:
        key = (id(program), program.version, self.num_stages, tuple(fetch_names))
        hit = self._partitions.get(key)
        if hit is None:
            staged = split_program(program, num_stages=self.num_stages,
                                   extra_targets=list(fetch_names))
            self._partitions[key] = (program, staged)  # the key uses id(program)
            return staged
        return hit[1]

    def _execute(self, program: Program, env: Dict[str, Any], fetch_names, persist,
                 gen: torch.Generator) -> None:
        ops = program.global_block().ops
        if not any(op.type == "autodiff" for op in ops):
            return super()._execute(program, env, fetch_names, persist, gen)
        self._dispatched = True
        self._staged_step(program, self._staged(program, fetch_names), env,
                          list(fetch_names), set(persist), gen)

    # -- the staged step -------------------------------------------------
    def _staged_step(self, program: Program, staged: StagedProgram, env: Dict[str, Any],
                     fetch_names: List[str], persist: set, gen: torch.Generator) -> None:
        block = program.global_block()
        K, M = staged.num_stages, self.num_microbatches
        T = M + K - 1
        stages = staged.stages
        amp = program.amp_dtype
        specials = {AMP_KEY: amp, registry.PROGRAM_KEY: program}
        live = {n for b in program.blocks for op in b.ops for names in op.inputs.values()
                for n in names} | set(fetch_names) | persist
        specials[registry.LIVE_KEY] = live
        feed_names = [n for n in env if not n.startswith("@") and n not in persist]
        for n in feed_names:
            if isinstance(env[n], LoDArray):
                raise NotImplementedError(
                    f"pipeline: LoD feed {n!r} — variable-length batches cannot be split "
                    "into fixed microbatches")
        ad_op = next(op for op in block.ops if op.type == "autodiff")
        leaves, tape = self._grad_leaves(program, ad_op, env)
        if tape is not None:  # split_program refuses these first
            raise NotImplementedError("pipeline: sparse_update params are not supported by "
                                      "the staged schedule")
        feeds_mb: Dict[str, list] = {}
        for n in feed_names:
            v = env[n]
            if getattr(v, "ndim", 0) < 1 or v.shape[0] % M:
                raise ValueError(
                    f"pipeline: feed {n!r} batch dim {tuple(getattr(v, 'shape', ()))} is not "
                    f"divisible by microbatches={M}")
            feeds_mb[n] = list(v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:])).unbind(0))

        produced_at: Dict[str, int] = {}
        for st in stages:
            for op in st.ops:
                for n in op.output_names():
                    produced_at.setdefault(n, st.index)
        targets = [n for n in dict.fromkeys([staged.loss_name, *staged.tail_fwd_names,
                                             *fetch_names]) if n in produced_at]
        stage_remat = bool(program.remat_policy) or self.schedule == "1f1b"
        policy = program.remat_policy or "full"
        devs = self.stage_devices

        def on(v, dev):
            return v if v.device == dev else v.to(dev, non_blocking=True)

        # ---- forward ticks ---------------------------------------------
        bounds: Dict[tuple, Dict[str, Any]] = {}  # (s, m) -> the values leaving stage s
        saved: Dict[tuple, tuple] = {}  # (s, m) -> (inputs, outputs, loss) for the drain
        collected: Dict[str, list] = {n: [None] * M for n in targets}
        with torch.enable_grad():
            stage_leaves = [{n: on(leaves[n], devs[st.index]) for n in st.state_names
                             if n in leaves} for st in stages]
            for t in range(T):
                for s in range(K):
                    m = t - s
                    if not 0 <= m < M:
                        continue  # a bubble cell
                    st, dev = stages[s], devs[s]
                    senv: Dict[str, Any] = dict(specials)
                    senv[registry.RNG_KEY] = self._mb_gens[m]
                    for n in st.state_names:
                        if n in stage_leaves[s]:
                            senv[n] = stage_leaves[s][n]
                        elif n in env:
                            senv[n] = on(env[n], dev)
                    for n in st.feed_names:
                        senv[n] = on(feeds_mb[n][m], dev)
                    ins = {}
                    if s > 0:
                        for n, v in bounds.pop((s - 1, m)).items():
                            x = on(v.detach(), dev)
                            if v.requires_grad:
                                x.requires_grad_(True)
                            ins[n] = senv[n] = x
                    here = [n for n in targets if produced_at[n] == s]
                    if stage_remat:
                        run_forward(self._runner(program), st.ops, senv, block, policy,
                                    set(st.out_names) | set(here))
                    else:
                        self._runner(program).run_ops(st.ops, senv, block)
                    outs = {n: senv[n] for n in st.out_names} if s < K - 1 else {}
                    bounds[(s, m)] = outs
                    for n in here:
                        collected[n][m] = senv[n]
                    loss = senv[staged.loss_name] if produced_at[staged.loss_name] == s \
                        else None
                    saved[(s, m)] = (ins, outs, loss)

        # ---- the backward drain ------------------------------------------
        grads: Dict[str, torch.Tensor] = {}
        back: Dict[tuple, Dict[str, torch.Tensor]] = {}  # (s, m) -> its outputs' gradients
        for t in reversed(range(T)):
            for s in reversed(range(K)):
                m = t - s
                if not 0 <= m < M:
                    continue
                ins, outs, loss = saved.pop((s, m))
                ograds = back.pop((s, m), {})
                tensors, seeds = [], []
                if loss is not None:
                    tensors.append(loss.reshape(()))
                    seeds.append(torch.full((), 1.0 / M, dtype=loss.dtype, device=loss.device))
                for n, v in outs.items():
                    if n in ograds:
                        tensors.append(v)
                        seeds.append(ograds[n])
                wrt_p = list(stage_leaves[s].items())
                wrt_in = [(n, x) for n, x in ins.items() if x.requires_grad]
                if not tensors:
                    continue
                gs = torch.autograd.grad(tensors, [x for _, x in wrt_p + wrt_in],
                                         grad_outputs=seeds, allow_unused=True)
                for (p, _), g in zip(wrt_p, gs[:len(wrt_p)]):
                    if g is None:
                        continue
                    g = on(g, self.device)
                    grads[p] = g if p not in grads else grads[p] + g
                if s > 0:
                    back[(s - 1, m)] = {n: on(g, devs[s - 1]) for (n, _), g in
                                        zip(wrt_in, gs[len(wrt_p):]) if g is not None}

        # ---- the tail, once, on the micro-batch means and summed grads ---
        with torch.no_grad():
            for p in staged.param_names:
                if p in leaves:
                    env[grad_var_name(p)] = grads.get(p, torch.zeros_like(leaves[p]))
            for n in targets:
                vals = [v.detach() for v in collected[n]]
                if vals[0].numel() <= 1:
                    acc = torch.zeros((), dtype=torch.float32, device=self.device)
                    for v in vals:
                        acc = acc + on(v, self.device).reshape(()).to(torch.float32)
                    env[n] = (acc / M).to(vals[0].dtype).reshape(vals[0].shape)
                else:
                    env[n] = torch.cat([on(v, self.device) for v in vals], 0)
            if self._dp_group_size() > 1:  # ranks of equal rows weigh alike
                self._reduction().gradients(
                    env, [grad_var_name(p) for p in staged.param_names
                          if grad_var_name(p) in env], 1.0)
            env[registry.RNG_KEY] = gen
            env.update(specials)
            tail_start = block.ops.index(ad_op) + 1
            self._run_tail(self._runner(program), staged.tail_ops, env, block, tail_start)
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"pipeline fetch {n!r} not produced by the staged step "
                               "(forward activations, persistables and tail outputs are "
                               "fetchable)")


# -- observability -----------------------------------------------------------

def _register_pipeline_metrics(ex: PipelineExecutor) -> None:
    """Declared at construction: the bubble and occupancy families exist (at
    0) from the moment the executor does. Their values are the schedule's
    arithmetic (K and M), so a scrape never reads the device."""
    from ..obs import metrics as obs
    from .elastic import declare_reshard_counter

    declare_reshard_counter()
    ref = weakref.ref(ex)

    def collect():
        e = ref()
        if e is None:
            return []
        k, m = e.num_stages, e.num_microbatches
        t = m + k - 1
        live = bool(e._dispatched)
        return [
            ("pt_pipeline_bubble_fraction", "gauge",
             "analytic GPipe bubble (K-1)/(M+K-1) of the active schedule (0 before the "
             "first staged dispatch)",
             [(None, (k - 1) / t if live else 0.0)]),
            ("pt_pipeline_stage_occupancy", "gauge",
             "fraction of schedule ticks each stage spends on real microbatches, "
             "M/(M+K-1) (0 before the first staged dispatch)",
             [({"stage": str(s)}, m / t if live else 0.0) for s in range(k)]),
        ]

    obs.registry().add_collector(collect)
    ex._metrics_collector = collect
