"""Continuous batching for generation serving: a token-level scheduler over
a fixed pool of decode slots (paddle_tpu/serving/scheduler.py).

The batch-mode `beam_search_group` op decodes `max_len` steps whatever
its requests' lengths, and a new request waits for its whole batch to
drain. The scheduler keeps `max_slots` decode slots whose state (beam
memories, scores, the (parent, token) trellis) stays on the device between
steps, in a `DecodeState` of fixed buffers. Each turn of its worker:

  1. ADMIT  - queued requests take free slots: a request's prefix ops (those
              before the generation op) run once through the engine's batch
              buckets, or its state comes from the prefix cache, and each
              row's boot state is copied into its slot's buffers;
  2. STEP   - ONE pool step advances every active slot by a token: the
              `beam_step` the batch op loops (ops/generation_ops.py), then
              the write on active slots and the trellis column;
  3. STREAM - each active slot's best-beam token goes to its request's
              events (provisional until the final backtrack);
  4. RETIRE - a slot whose beams all finished, or that reached max_len, is
              backtracked on the host from its own `step[s]` columns and
              freed for the next admission.

The card: the pool step is one CUDA graph replayed once a token
(`CapturedStep`, core/graph.py, shared with the Trainer's windows). Its
first run on the pool's geometry is eager; the capture follows (in
`warmup()`, or at the second live step); then it replays. After it the
host reads back ONE packed int32 tensor - the steps each slot took (its
token is beam 0's trellis entry), whether all its beams are done, its step,
and its trellis and scores - with one copy: one host sync a pool step
(`syncs_total`), and retiring a slot reads nothing more. Admission and retirement stay eager and copy nothing
back: a slot's admit is a few device copies into the buffers, its feed goes
up from pinned memory without a fence. A step that cannot be captured
raises, naming the op; nothing falls back to an eager step on the card. On
the CPU every step runs eagerly on the same buffers.

Threads: one worker owns the pool; any number of clients `submit()`. The
worker's device work (prefix runs and steps, the capture) holds the
engine's lock, which serializes it with the micro-batcher's `predict`.

Deadline and shed semantics are the MicroBatcher's (AdmissionQueue): a
bounded queue sheds with ShedError (503); deadlines are checked at
admission and again after the first step, so a request never streams a
late first token (DeadlineError, 504). A shared CircuitBreaker counts step
failures, and the `serving.predict` fault point fires on every pool step:
a fault aborts the requests in flight with GenerationAborted (503,
retryable) and frees their slots.

The prefix cache (`prefix_cache_mb`): each raw feed row is hashed, and its
prefix state (boots and per-example rows) stays on the device in a
byte-budgeted LRU (serving/prefix_cache.py); a hit admits from it with no
prefix run. With `prefix_cache_quant="int8"` entries are int8 with a
per-tensor scale, dequantized in the admit copy.

Speculative decoding (`draft_model`, or the artifact's draft sidecar): a
small generation model over the same vocabulary keeps its own
single-hypothesis slot state and proposes `draft_k` tokens a slot greedily
(`greedy_step`, the propose step); the target then runs `draft_k` pool-step
updates in one verify step, each applied only while its slot's `go` mask
holds: a slot stops at the first step whose best-beam token differs from
the proposal, KEEPING that target token, or when it finishes. Every applied
step is the pool step's update on the pool's own S·K rows, so the output
equals plain decoding bit for bit whatever the draft proposes; the draft
decides only how many tokens a round moves. After verify each slot's draft
state is taken from the propose history (a gather, never a replay). On the
card propose and verify are each one CapturedStep, eager once, then
captured, then replayed; a round reads back the same ONE packed tensor as
a pool step: one host sync a round.

Disaggregated serving: `prefill()` runs only the prefix and returns the
request's boot state on the host (one device-to-host copy); a decode
replica's `submit_handoff()` puts such state on its device and admits it
through the same slot copies a local prefix takes.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..amp import AMP_KEY
from ..core.executor import BlockRunner
from ..core.graph import CapturedStep
from ..core.registry import RNG_KEY
from ..obs import trace as obs_trace
from ..ops import beam_common
from ..ops.generation_ops import (DecodeState, beam_step, find_generation_op, gen_spec_from_op,
                                  greedy_step)
from ..ops.math_ops import _torch_dtype
from ..ops.quant_kernels import INT8_MAX
from ..resilience import faults
from ..resilience.breaker import CircuitBreaker, CircuitOpenError
from .batcher import AdmissionQueue, DeadlineError, ShedError
from .metrics import FIRST_TOKEN_BUCKETS, TOKEN_INTERVAL_BUCKETS, VERIFY_ROUND_BUCKETS, MetricSet
from .prefix_cache import PrefixCache, prefix_row_key

__all__ = ["ContinuousScheduler", "GenHandle", "GenerationAborted", "DeadlineError", "ShedError",
           "CircuitOpenError"]


class GenerationAborted(ShedError):
    """A pool step failed mid-flight: the request was aborted and its slots
    recovered; retry (HTTP 503 with Retry-After)."""


class GenHandle:
    """A client's handle on one generation request.

    `events()` yields dicts as decoding goes:
      {"event": "token", "row": r, "step": t, "token": id}   a step
      {"event": "done",  "outputs": {...}}                   terminal
      {"event": "error", "error": msg, "kind": clsname}      terminal
    `result()` blocks to the terminal event and returns the outputs (ids
    [n,K,T], scores [n,K], lengths [n,K]) or raises."""

    def __init__(self, rows: int):
        self.rows = rows
        self.request_id: Optional[str] = None
        self._q: "queue.Queue[dict]" = queue.Queue()
        self._done = threading.Event()
        self._outputs: Optional[Dict[str, np.ndarray]] = None
        self._exc: Optional[BaseException] = None

    def _emit_token(self, row: int, step: int, token: int) -> None:
        self._q.put({"event": "token", "row": row, "step": step, "token": token})

    def _finish(self, outputs: Dict[str, np.ndarray]) -> None:
        self._outputs = outputs
        self._done.set()
        self._q.put({"event": "done", "outputs": outputs})

    def _fail(self, exc: BaseException) -> None:
        if self._done.is_set():
            return
        self._exc = exc
        self._done.set()
        self._q.put({"event": "error", "error": str(exc), "kind": type(exc).__name__})

    def events(self, timeout: Optional[float] = None):
        while True:
            ev = self._q.get(timeout=timeout)
            yield ev
            if ev["event"] in ("done", "error"):
                return

    def result(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        if not self._done.wait(timeout=timeout):
            raise DeadlineError("generation result timed out")
        if self._exc is not None:
            raise self._exc
        return self._outputs


class _GenRequest:
    __slots__ = ("feed", "rows", "handle", "deadline", "submitted_at", "first_token_at",
                 "last_token_at", "boots", "pes", "dboots", "dpes", "cached", "cache_keys",
                 "next_row", "live_rows", "results", "failed", "request_id", "slo_class",
                 "enqueued_at")

    def __init__(self, feed, rows: int, deadline: float, request_id: Optional[str] = None,
                 slo_class: str = "interactive"):
        self.feed = feed
        self.rows = rows
        self.slo_class = slo_class
        self.enqueued_at = 0.0  # stamped by AdmissionQueue.put
        # every span the request touches, on any thread, carries this id
        self.request_id = request_id or obs_trace.new_request_id("gen")
        self.handle = GenHandle(rows)
        self.handle.request_id = self.request_id
        self.deadline = deadline
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.boots = None  # the prefix's outputs, [nb, ...] each (a handoff's: [n, ...])
        self.pes = None
        self.dboots = None  # the draft model's prefix outputs
        self.dpes = None
        self.cached = None  # row -> PrefixCache payload (an all-hit request)
        self.cache_keys = None  # row -> cache key
        self.next_row = 0  # the next row not admitted
        self.live_rows = 0  # rows holding slots
        self.results: Dict[int, tuple] = {}  # row -> (ids, scores, lengths)
        self.failed = False

    def fail(self, exc: BaseException) -> None:
        """Terminal failure (the AdmissionQueue contract)."""
        self.failed = True
        self.handle._fail(exc)


class _GraphStep(CapturedStep):
    """A step of the scheduler on its fixed buffers: eager on the CPU; on
    the card eager once, then captured as one CUDA graph and replayed.
    `n_gens` generators, one a decode step the body runs, each reseeded to
    0 before a run: the JAX steps draw from PRNGKey(0) at every step."""

    def __init__(self, sched: "ContinuousScheduler", n_gens: int = 1):
        super().__init__(sched.device, torch.Generator(device=sched.device))
        self.extra_gens = tuple(torch.Generator(device=sched.device) for _ in range(n_gens - 1))
        self.sched = sched
        self.warm = False
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0

    @property
    def gens(self) -> Tuple[torch.Generator, ...]:
        return (self.gen,) + self.extra_gens

    def _seed(self) -> None:
        for g in self.gens:
            g.manual_seed(0)

    def step(self) -> None:
        self._seed()
        if not self.cuda:
            self._body()
            self.eager_steps += 1
            return
        if not self.warm:
            self._on_stream(self._body)
            self.warm = True
            self.eager_steps += 1
            return
        if self.graph is None:
            self._capture()
            self.captures += 1
        self.replay()
        self.replays += 1

    def prime(self) -> None:
        """Warm-up on the card: the eager run (no slot active, so it writes
        nothing that matters) and the capture, without a replay."""
        if not self.cuda or self.graph is not None:
            return
        self._seed()
        if not self.warm:
            self._on_stream(self._body)
            self.warm = True
            self.eager_steps += 1
        self._capture()
        self.captures += 1

    def counts(self) -> Dict[str, Any]:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps, "capture_s": self.capture_s}


class _PoolStep(_GraphStep):
    """The pool step: `beam_step` over every slot, the masked writes on
    active slots, the trellis column, and the packed readback."""

    what = "the generation pool step"

    def _body(self) -> None:
        s = self.sched
        s._apply_beam_step(s._active_dev, self.gen)
        s._pack(s._active_dev[:, None])


class _ProposeStep(_GraphStep):
    """The draft's `draft_k` greedy steps from its slot state: the proposals
    [D, S] and each step's memories [D, S, ...] (the history verify's draft
    sync gathers from). The draft's slot state itself is left as it was."""

    what = "the speculative propose step"

    def __init__(self, sched: "ContinuousScheduler"):
        super().__init__(sched, n_gens=sched.draft_k)

    def _body(self) -> None:
        d = self.sched._draft
        mems, tok = d.mems, d.tok
        for i, gen in enumerate(self.gens):
            env = dict(d.params)
            env[AMP_KEY] = d.amp
            env[RNG_KEY] = gen
            for name, v in zip(d.spec.per_example, d.pe):
                env[name] = v
            mems, tok = greedy_step(d.runner, d.block, d.spec, env, mems, tok)
            d.drafts[i].copy_(tok)
            for h, m in zip(d.hist, mems):
                h[i].copy_(m)


class _VerifyStep(_GraphStep):
    """One speculative round's verify: `draft_k` pool-step updates under
    the per-slot `go` mask (on the device: no host branch), then the draft
    sync and the packed readback, whose first column is the steps each slot
    took."""

    what = "the speculative verify step"

    def __init__(self, sched: "ContinuousScheduler"):
        super().__init__(sched, n_gens=sched.draft_k)

    def _body(self) -> None:
        s = self.sched
        st, d, T = s._state, s._draft, s.spec.max_len
        step0 = st.step.clone()
        go = s._active_dev.clone()
        for i, gen in enumerate(self.gens):
            new_tok = s._apply_beam_step(go, gen)
            go = go & (new_tok[:, 0] == d.drafts[i]) & (st.step < T) & ~st.fin.all(dim=1)
        adv = st.step - step0  # [S] the steps applied, 0..D
        # after `a` steps the draft state that consumed the emitted tokens
        # is propose-history row a-1 (inputs: the old token and proposals
        # 0..a-2, which matched); the last emitted token is its next input
        moved = adv > 0
        idx = (adv - 1).clamp(min=0).long()
        for dm, h in zip(d.mems, d.hist):
            dm.copy_(torch.where(moved.reshape((-1,) + (1,) * (dm.dim() - 1)),
                                 h[idx, s._slot_ids], dm))
        d.tok.copy_(torch.where(moved, st.tok[:, 0], d.tok))
        s._pack(adv[:, None])


class _Draft:
    """The speculative draft: its engine and step program, and its slot
    state (memories [S, ...], last token [S], per-example rows [S, ...]) with
    the propose step's outputs."""

    def __init__(self, engine, draft_dir: str, spec, prefix_ops, block0, runner, block):
        self.engine = engine
        self.dir = draft_dir
        self.spec = spec
        self.params = {v.name: engine.scope.get(v.name) for v in engine.program.persistables()
                       if engine.scope.has(v.name)}
        self.prefix_ops = prefix_ops
        self.block0 = block0
        self.runner = runner
        self.block = block
        self.amp = engine.program.amp_dtype
        self.mem_specs = self.pe_specs = None
        self.mems = self.tok = self.pe = None
        self.drafts = self.hist = None


class ContinuousScheduler:
    """Token-level continuous-batching scheduler over one engine's
    generation model. One worker thread owns the decode pool; any number of
    client threads submit()."""

    def __init__(self, engine, max_slots: int = 8, max_queue: int = 64,
                 timeout_ms: float = 30000.0, breaker: Optional[CircuitBreaker] = None,
                 metrics: Optional[MetricSet] = None, prefix_cache_mb: float = 0.0,
                 prefix_cache_quant: Optional[str] = None, draft_model: Optional[str] = None,
                 draft_k: int = 4):
        self.engine = engine
        op = find_generation_op(engine.program)
        if op is None:
            raise ValueError(
                f"model {engine.model_name!r} has no beam_search_group op: continuous "
                "batching serves generation programs (layers.BeamSearchDecoder); use "
                "predict() for feed-forward models")
        self.spec = gen_spec_from_op(op)
        block0 = engine.program.global_block()
        gen_idx = block0.ops.index(op)
        if any(o.type != "beam_search_group" for o in block0.ops[gen_idx + 1:]):
            raise ValueError("ops after the beam_search_group op are not supported by the "
                             "continuous scheduler (the pool step cannot run them a token "
                             "at a time)")
        self._prefix_ops = block0.ops[:gen_idx]
        self._block0 = block0
        self._block = engine.program.blocks[self.spec.sub_block]
        self._runner = BlockRunner(engine.program)
        self._check_step_closures(engine.program)
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.timeout_s = timeout_ms / 1e3
        self.breaker = breaker
        self.metrics = metrics or engine.metrics
        self.device = engine.device
        # generation serving holds the weights frozen (the engine's
        # contract): the scope's tensors, read by every step
        scope = engine.scope
        self._params = {v.name: scope.get(v.name) for v in engine.program.persistables()
                        if scope.has(v.name)}

        # the pool: allocated from the generation sidecar (warmup) or on
        # the first admission
        self._state: Optional[DecodeState] = None
        self._mem_specs = None  # ((trailing shape, torch dtype), ...)
        self._pe_specs = None
        self._active_dev: Optional[torch.Tensor] = None  # [S] bool on the device
        self._packed: Optional[torch.Tensor] = None  # the step's readback
        self._pool: Optional[_PoolStep] = None
        self._propose: Optional[_ProposeStep] = None
        self._verify: Optional[_VerifyStep] = None

        if prefix_cache_quant not in (None, "int8"):
            raise ValueError(f"unsupported prefix_cache_quant {prefix_cache_quant!r} "
                             "(only 'int8')")
        self.prefix_cache_quant = prefix_cache_quant
        self._pcache = (PrefixCache(int(prefix_cache_mb * (1 << 20)))
                        if prefix_cache_mb > 0 else None)

        # the draft is loaded and checked here, so a bad draft fails at
        # construction; `draft_model` overrides the artifact's sidecar, a
        # relative sidecar path resolves against the artifact
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        self.draft_k = int(draft_k)
        self._draft: Optional[_Draft] = None
        draft_dir = draft_model or (getattr(engine, "draft_meta", None) or {}).get("dir")
        if draft_dir and not os.path.isabs(draft_dir) and getattr(engine, "model_dir", None):
            cand = os.path.join(engine.model_dir, draft_dir)
            if os.path.isdir(cand):
                draft_dir = cand
        if draft_dir:
            self._init_draft(draft_dir)

        self._cond = threading.Condition()
        # the admission queue shares MicroBatcher's deadline and shed
        # semantics (serving/batcher.py)
        self._aq = AdmissionQueue(max_queue, self._cond, self.metrics, prefix="gen_")
        self._slot_req: List[Optional[Tuple[_GenRequest, int]]] = [None] * max_slots
        self._active = np.zeros(max_slots, bool)
        self._partial: Optional[_GenRequest] = None  # rows still waiting
        self._worker: Optional[threading.Thread] = None
        self._stopping = False

        self.dispatches_total = 0
        self.syncs_total = 0
        self.steps_total = 0
        self.admitted_total = 0
        self.retired_total = 0
        self.tokens_total = 0
        self.prefixes_total = 0
        self.prefills_total = 0  # prefill-phase requests served (disaggregated)
        self.handoffs_admitted_total = 0  # handoff requests queued for the pool
        self.verify_rounds_total = 0
        self._draft_proposed = 0
        self._draft_accepted = 0
        self._occupancy_steps = 0  # the active-slot count summed over steps
        self._first_tok = self.metrics.histogram(
            "gen_first_token_seconds", buckets=FIRST_TOKEN_BUCKETS,
            help="submit-to-first-streamed-token latency")
        self._per_tok = self.metrics.histogram(
            "gen_token_seconds", buckets=TOKEN_INTERVAL_BUCKETS,
            help="inter-token interval per request")
        self.metrics.gauge("gen_slot_occupancy",
                           lambda: float(self._active.sum()) / self.max_slots,
                           help="fraction of decode slots occupied")
        self.metrics.gauge("gen_queue_depth", lambda: self._aq.depth(),
                           help="generation requests waiting for a slot")
        for name, text in (
                ("gen_requests_total", "generation requests accepted"),
                ("gen_steps_total", "decode pool steps executed"),
                ("gen_tokens_total", "tokens streamed across all generation requests"),
                ("circuit_open_total",
                 "requests rejected because the model's circuit breaker was open"),
                ("gen_prefix_hits_total",
                 "request rows admitted from the device-resident prefix cache"),
                ("gen_prefix_misses_total", "request rows that ran the prefix ops"),
                ("gen_prefix_cache_evictions_total",
                 "prefix states evicted from the device-resident LRU"),
                ("gen_prefill_total",
                 "prefill-phase requests served (prefix only, state shipped to a decode "
                 "replica)"),
                ("gen_handoff_admitted_total",
                 "handoff requests admitted into the decode pool"),
                ("gen_draft_tokens_total", "tokens proposed by the draft model"),
                ("gen_draft_accepted_total",
                 "proposed tokens turned into emitted target tokens (the correcting target "
                 "step included)"),
                ("gen_verify_rounds_total",
                 "speculative rounds (one propose and one verify each)")):
            self.metrics.declare_counter(name, help=text)
        self._verify_lat = self.metrics.histogram(
            "gen_verify_round_seconds", buckets=VERIFY_ROUND_BUCKETS,
            help="latency of one speculative round (propose, verify, the host fence)")
        self.metrics.gauge("gen_accept_rate",
                           lambda: (self._draft_accepted / self._draft_proposed
                                    if self._draft_proposed else 0.0),
                           help="fraction of the drafted window turned into emitted tokens")
        self.metrics.gauge("gen_prefix_cache_entries",
                           lambda: float(len(self._pcache)) if self._pcache else 0.0,
                           help="prefix states resident in the device LRU")
        self.metrics.gauge("gen_prefix_cache_bytes",
                           lambda: float(self._pcache.bytes) if self._pcache else 0.0,
                           help="device bytes held by cached prefix states")
        self.metrics.gauge("gen_prefix_hit_rate",
                           lambda: self._pcache.hit_rate() if self._pcache else 0.0,
                           help="prefix cache hit rate since start")

    def _check_step_closures(self, program, spec=None) -> None:
        """The pool step's env holds parameters and declared per-example
        tensors only (batch mode sees the whole block-0 env): reject a step
        body that closes over another outer value up front. The draft's
        step body is held to the same contract."""
        spec = spec or self.spec
        persist = {v.name for v in program.persistables()}
        produced = {spec.prev_inner} | set(spec.mem_inner) | set(spec.per_example)
        refs: set = set()
        stack = [spec.sub_block]
        while stack:
            b = program.blocks[stack.pop()]
            for sop in b.ops:
                refs.update(n for n in sop.input_names() if n not in produced)
                produced.update(sop.output_names())
                inner = sop.attrs.get("sub_block")
                if isinstance(inner, int):
                    stack.append(inner)
        missing = sorted(refs - persist)
        if missing:
            raise ValueError(
                f"generation step body closes over non-parameter outer value(s) {missing}: "
                "continuous batching keeps only parameters and declared per-example tensors "
                "on the device; declare them with gen.per_example_input()")

    # -- speculative decoding -------------------------------------------
    def _init_draft(self, draft_dir: str) -> None:
        """Load and check the draft model: a generation model with the
        target's bos/eos and feeds, whose step body keeps the pool's env
        contract."""
        from .engine import ServingEngine

        d_eng = ServingEngine(draft_dir, policy=self.engine.policy,
                              model_name=f"{self.engine.model_name}.draft",
                              metrics=self.metrics, device=self.engine.device)
        dspec = d_eng.generation_spec()
        if dspec is None:
            raise ValueError(
                f"draft model {draft_dir!r} has no beam_search_group op: speculative decoding "
                "drafts with a (small) generation model over the same vocabulary")
        spec = self.spec
        if (dspec.bos_id, dspec.eos_id) != (spec.bos_id, spec.eos_id):
            raise ValueError(
                f"draft model {draft_dir!r} decodes with bos/eos=({dspec.bos_id},"
                f"{dspec.eos_id}) but the target uses ({spec.bos_id},{spec.eos_id}): draft "
                "proposals would never verify")
        if sorted(d_eng.feed_names) != sorted(self.engine.feed_names):
            raise ValueError(
                f"draft model feeds {sorted(d_eng.feed_names)} != target feeds "
                f"{sorted(self.engine.feed_names)}: the draft prefix runs on the SAME request "
                "feed")
        self._check_step_closures(d_eng.program, dspec)
        prog = d_eng.program
        block0 = prog.global_block()
        gen_idx = block0.ops.index(find_generation_op(prog))
        self._draft = _Draft(d_eng, draft_dir, dspec, block0.ops[:gen_idx], block0,
                             BlockRunner(prog), prog.blocks[dspec.sub_block])

    def _ensure_draft_pool(self, dmem_specs, dpe_specs) -> None:
        """The draft's slot state and the propose step's outputs, once per
        geometry."""
        d = self._draft
        if d.mems is not None:
            if (dmem_specs, dpe_specs) != (d.mem_specs, d.pe_specs):
                raise ValueError(
                    f"draft state geometry changed mid-serve: the pool holds "
                    f"{d.mem_specs}/{d.pe_specs}, the request produced "
                    f"{dmem_specs}/{dpe_specs}")
            return
        S, D, dev = self.max_slots, self.draft_k, self.device
        d.mem_specs, d.pe_specs = dmem_specs, dpe_specs
        d.mems = tuple(torch.zeros((S,) + shp, dtype=dt, device=dev) for shp, dt in dmem_specs)
        d.tok = torch.full((S,), d.spec.bos_id, dtype=torch.int32, device=dev)
        d.pe = tuple(torch.zeros((S,) + shp, dtype=dt, device=dev) for shp, dt in dpe_specs)
        d.drafts = torch.zeros((D, S), dtype=torch.int32, device=dev)
        d.hist = tuple(torch.zeros((D, S) + shp, dtype=dt, device=dev)
                       for shp, dt in dmem_specs)
        self._propose = _ProposeStep(self)
        self._ensure_verify()

    def _ensure_verify(self) -> None:
        """The verify step, once both the pool and the draft's state exist."""
        d = self._draft
        if (self._verify is None and d is not None and d.mems is not None
                and self._state is not None):
            self._verify = _VerifyStep(self)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "ContinuousScheduler":
        with self._cond:
            if self._worker is not None and self._worker.is_alive():
                return self
            self._stopping = False
            self._worker = threading.Thread(target=self._run,
                                            name=f"ptgen-{self.engine.model_name}",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self, drain: bool = False, drain_timeout_s: float = 60.0) -> None:
        """Stop the worker. drain=True lets queued and in-flight requests
        finish first (bounded by drain_timeout_s); whatever is still in
        flight then fails with a retryable ShedError."""
        if drain:
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                with self._cond:
                    if (not self._aq.depth() and not self._active.any()
                            and self._partial is None):
                        break
                time.sleep(0.01)
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
        self._aq.drain(ShedError("scheduler stopped"))
        with self._cond:
            self._abort_inflight_locked(ShedError("scheduler stopped"))

    # -- client side ----------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray], timeout_ms: Optional[float] = None,
               request_id: Optional[str] = None, slo: Optional[str] = None) -> GenHandle:
        self._admit_or_raise()
        rows = {v.shape[0] for v in feed.values() if hasattr(v, "ndim") and v.ndim >= 1}
        if len(rows) != 1:
            raise ValueError(f"generation feeds must share the batch axis; got row counts "
                             f"{sorted(rows)}")
        n = rows.pop()
        deadline = time.monotonic() + (timeout_ms / 1e3 if timeout_ms is not None
                                       else self.timeout_s)
        req = _GenRequest(feed, n, deadline, request_id=request_id,
                          slo_class=slo or "interactive")
        with self._cond:
            if self._stopping:
                raise ShedError("scheduler stopped")
        self._aq.put(req)  # sheds with ShedError when full
        if obs_trace._armed:
            obs_trace.instant("gen.enqueue", cat="gen", request_id=req.request_id, rows=n)
        self.metrics.counter_inc("gen_requests_total")
        return req.handle

    def generate(self, feed: Dict[str, np.ndarray],
                 timeout_ms: Optional[float] = None) -> Dict[str, np.ndarray]:
        """submit and wait, with MicroBatcher.predict's grace."""
        h = self.submit(feed, timeout_ms=timeout_ms)
        budget = timeout_ms / 1e3 if timeout_ms is not None else self.timeout_s
        return h.result(timeout=budget + max(1.0, budget))

    # -- the disaggregated phases (serving/disagg) -----------------------
    def _admit_or_raise(self) -> None:
        if self.breaker is not None and not self.breaker.admit():
            self.metrics.counter_inc("circuit_open_total")
            raise CircuitOpenError(f"circuit open for model {self.engine.model_name!r}; "
                                   "retry later")

    def prefill(self, feed: Dict[str, np.ndarray], request_id: Optional[str] = None):
        """The PREFILL phase: only the bucketed prefix ops, and the request's
        boot state (boots, per-example rows) cut to its true rows, on the
        host as CPU tensors: the payload of a prefill-to-decode handoff. No
        pool is touched. The whole state crosses to the host in one copy
        (one host sync)."""
        from .disagg.handoff import gather_handoff_rows

        self._admit_or_raise()
        rows = {v.shape[0] for v in feed.values() if hasattr(v, "ndim") and v.ndim >= 1}
        if len(rows) != 1:
            raise ValueError(f"generation feeds must share the batch axis; got row counts "
                             f"{sorted(rows)}")
        n = rows.pop()
        with obs_trace.span("gen.prefill", cat="gen", request_id=request_id, rows=n):
            (boots, pes), _ = self._prefix(feed, with_draft=False)
            with self.engine._lock:
                host = gather_handoff_rows(boots + pes, n)
        self.syncs_total += 1
        self.prefills_total += 1
        self.metrics.counter_inc("gen_prefill_total")
        return host[:len(boots)], host[len(boots):]

    def submit_handoff(self, boots, pes, timeout_ms: Optional[float] = None,
                       request_id: Optional[str] = None, slo: Optional[str] = None) -> GenHandle:
        """The DECODE phase: queue a request whose prefix state came over the
        wire (host tensors or arrays [n, ...] from a prefill replica's
        `prefill()`). The rows go to this scheduler's device here and are
        admitted by the worker through the same slot copies a local prefix
        takes. Deadline, shed and breaker as submit()."""
        from .disagg.handoff import restore_handoff_rows

        if self._draft is not None:
            raise ValueError(
                "disaggregated handoff does not carry draft-model state: serve the decode "
                "class without --draft_model (speculative decoding composes with monolithic "
                "serving only)")
        self._admit_or_raise()
        boots, pes = tuple(boots), tuple(pes)
        rows = {int(a.shape[0]) for a in boots + pes}
        if len(rows) != 1:
            raise ValueError(f"handoff state arrays must share the row axis; got row counts "
                             f"{sorted(rows)}")
        n = rows.pop()
        deadline = time.monotonic() + (timeout_ms / 1e3 if timeout_ms is not None
                                       else self.timeout_s)
        req = _GenRequest(None, n, deadline, request_id=request_id,
                          slo_class=slo or "interactive")
        with self.engine._lock:
            req.boots = restore_handoff_rows(boots, self.device)
            req.pes = restore_handoff_rows(pes, self.device)
        with self._cond:
            if self._stopping:
                raise ShedError("scheduler stopped")
        self._aq.put(req)  # sheds with ShedError when full
        if obs_trace._armed:
            obs_trace.instant("gen.handoff_enqueue", cat="gen", request_id=req.request_id,
                              rows=n)
        self.handoffs_admitted_total += 1
        self.metrics.counter_inc("gen_handoff_admitted_total")
        self.metrics.counter_inc("gen_requests_total")
        return req.handle

    # -- the pool -------------------------------------------------------
    def _ensure_pool(self, mem_specs, pe_specs) -> None:
        """The DecodeState buffers, once per geometry (fixed by the program,
        not by the traffic)."""
        if self._state is not None:
            if (mem_specs, pe_specs) != (self._mem_specs, self._pe_specs):
                raise ValueError(
                    f"generation state geometry changed mid-serve: the pool holds "
                    f"{self._mem_specs}/{self._pe_specs}, the request produced "
                    f"{mem_specs}/{pe_specs}; decode-state trailing shapes must be static")
            return
        spec, S, dev = self.spec, self.max_slots, self.device
        K, T = spec.beam_size, spec.max_len
        self._mem_specs, self._pe_specs = mem_specs, pe_specs
        self._state = DecodeState(
            mems=tuple(torch.zeros((S, K) + shp, dtype=dt, device=dev) for shp, dt in mem_specs),
            tok=torch.full((S, K), spec.bos_id, dtype=torch.int32, device=dev),
            scores=torch.zeros((S, K), dtype=torch.float32, device=dev),
            fin=torch.ones((S, K), dtype=torch.bool, device=dev),
            step=torch.zeros((S,), dtype=torch.int32, device=dev),
            parents=torch.zeros((S, K, T), dtype=torch.int32, device=dev),
            trellis_tok=torch.full((S, K, T), spec.eos_id, dtype=torch.int32, device=dev),
            pe=tuple(torch.zeros((S * K,) + shp, dtype=dt, device=dev) for shp, dt in pe_specs))
        self._active_dev = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._cols = torch.arange(T, dtype=torch.int32, device=dev)
        self._init_row = beam_common.init_scores(1, K, device=dev)[0].contiguous()
        self._slot_ids = torch.arange(S, device=dev)
        self._packed = torch.zeros((S, 3 + 2 * K * T + K), dtype=torch.int32, device=dev)
        self._pool = _PoolStep(self)
        self._ensure_verify()

    def _apply_beam_step(self, mask: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """One `beam_step` over the pool's S·K rows, written where `mask`
        [S] holds: memories, tokens, scores, done flags, the trellis column
        at each slot's step, and the step. Shared by the pool step and every
        step of verify, so a verified token is the pool step's bit for bit.
        Returns the step's tokens [S, K], written or not."""
        spec, st = self.spec, self._state
        env = dict(self._params)
        env[AMP_KEY] = self.engine.program.amp_dtype
        env[RNG_KEY] = gen
        for name, v in zip(spec.per_example, st.pe):
            env[name] = v
        new_mems, new_tok, new_sc, new_fin, parent = beam_step(
            self._runner, self._block, spec, env, st.mems, st.tok, st.scores, st.fin)
        for m, nm in zip(st.mems, new_mems):
            m.copy_(torch.where(mask.reshape((-1,) + (1,) * (m.dim() - 1)), nm, m))
        at_t = (self._cols[None, None, :] == st.step[:, None, None]) & mask[:, None, None]
        st.parents.copy_(torch.where(at_t, parent[:, :, None].to(torch.int32), st.parents))
        st.trellis_tok.copy_(torch.where(at_t, new_tok[:, :, None], st.trellis_tok))
        m2 = mask[:, None]
        st.tok.copy_(torch.where(m2, new_tok, st.tok))
        st.scores.copy_(torch.where(m2, new_sc, st.scores))
        st.fin.copy_(torch.where(m2, new_fin, st.fin))
        st.step.add_(mask.to(torch.int32))
        return new_tok

    def _pack(self, first: torch.Tensor) -> None:
        """The readback: `first` [S, 1] int32, the steps each slot took this
        round, then each slot's all-done flag, its step, its trellis and its
        scores' bits."""
        st, S = self._state, self.max_slots
        self._packed.copy_(torch.cat([
            first.to(torch.int32), st.fin.all(dim=1, keepdim=True).to(torch.int32),
            st.step[:, None], st.parents.reshape(S, -1), st.trellis_tok.reshape(S, -1),
            st.scores.view(torch.int32)], dim=1))

    @staticmethod
    def _specs_from_meta(program):
        meta = getattr(program, "_generation_meta", None)
        if not meta:
            return None

        def specs(entries):
            return tuple((tuple(int(d) for d in m["shape"]), _torch_dtype(m["dtype"]))
                         for m in entries)

        try:
            return specs(meta.get("state", [])), specs(meta.get("per_example", []))
        except (KeyError, TypeError, ValueError):
            return None

    def warmup(self) -> int:
        """Sizes the pool (and the draft's slot state) from the artifacts'
        generation sidecars (io.save_inference_model) and, on the card, runs
        the pool step (and propose and verify) once and captures it, before
        any request; then runs the prefix ops once at each batch bucket.
        Returns the captures and prefix buckets run."""
        if self._state is None:
            specs = self._specs_from_meta(self.engine.program)
            if specs is not None:
                self._ensure_pool(*specs)
        d = self._draft
        if d is not None and d.mems is None:
            specs = self._specs_from_meta(d.engine.program)
            if specs is not None:
                self._ensure_draft_pool(*specs)
        done = 0
        for step in (self._pool, self._propose, self._verify):
            if step is not None and step.cuda and step.graph is None:
                with self.engine._lock, torch.no_grad():
                    step.prime()
                done += 1
        pol = self.engine.policy
        if self._prefix_ops:
            for nb in pol.batch_buckets:
                for tb in (pol.seq_len_buckets or (None,)):
                    feed = self.engine._zero_bucket_feed(nb, tb)
                    if feed is not None:
                        self._prefix(feed)
                        done += 1
        return done

    # -- the worker -----------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while (not self._aq.depth() and not self._active.any()
                       and self._partial is None and not self._stopping):
                    self._cond.wait()
                if self._stopping:
                    return
            try:
                self._admit_ready()
            except Exception:
                # admission failures reach their handles in _admit_ready;
                # anything here is a scheduler fault: keep serving
                import traceback

                traceback.print_exc()
            if self._active.any():
                if self._draft is not None:
                    self._spec_round()
                else:
                    self._step_once()
            else:
                time.sleep(0.001)  # queued but nothing admitted

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_slots) if not self._active[i]]

    def _admit_ready(self) -> None:
        free = self._free_slots()
        while free:
            req = self._partial
            if req is None:
                with self._cond:
                    # pop() fails requests already past their deadline
                    req = self._aq.pop()
                if req is None:
                    return
                try:
                    self._run_prefix(req)
                except Exception as e:
                    req.fail(e)
                    free = self._free_slots()
                    continue
            admitted_any = False
            with obs_trace.span("gen.admit", cat="gen", request_id=req.request_id):
                while free and req.next_row < req.rows:
                    slot = free.pop(0)
                    self._admit_row(req, req.next_row, slot)
                    req.next_row += 1
                    req.live_rows += 1
                    admitted_any = True
            self._partial = req if req.next_row < req.rows else None
            # the deadline again after admission: the prefix run may have
            # eaten the budget; free the slots rather than stream late
            if admitted_any and req.first_token_at is None and req.deadline <= time.monotonic():
                self._evict_request(req)
                self._aq.expire(req, "deadline exceeded during slot admission (warm the "
                                     "engine)")
            free = self._free_slots()
            if self._partial is not None:
                return  # the head-of-line request owns the next free slots

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A feed array on the scheduler's device; on the card from pinned
        memory without a fence (the caching host allocator keeps the pinned
        block until the copy is done)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefix(self, feed: Dict[str, np.ndarray], with_draft: bool = True):
        """The prefix ops on a feed padded to its batch bucket: (boots,
        per-example values), [nb, ...] each, on the device; and the draft
        model's, on the same feed, when there is a draft and `with_draft`
        (else None)."""
        padded, _, _ = self.engine._pad_feed({k: np.asarray(v) for k, v in feed.items()})
        dev_feed = {k: self._to_device(v) for k, v in padded.items()}
        models = [(self._params, self._runner, self._prefix_ops, self._block0, self.spec,
                   self.engine.program.amp_dtype)]
        d = self._draft if with_draft else None
        if d is not None:
            models.append((d.params, d.runner, d.prefix_ops, d.block0, d.spec, d.amp))
        out = []
        for params, runner, ops, block0, spec, amp in models:
            env = dict(params)
            env.update(dev_feed)
            env[AMP_KEY] = amp
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            env[RNG_KEY] = gen
            with self.engine._lock, torch.no_grad():
                runner.run_ops(ops, env, block0)
            self.dispatches_total += 1
            out.append((tuple(env[n] for n in spec.boot_names),
                        tuple(env[n] for n in spec.per_example_names)))
        self.prefixes_total += 1
        return out[0], (out[1] if d is not None else None)

    @staticmethod
    def _geometry(part):
        boots, pes = part
        return (tuple((tuple(b.shape[1:]), b.dtype) for b in boots),
                tuple((tuple(p.shape[1:]), p.dtype) for p in pes))

    def _run_prefix(self, req: _GenRequest) -> None:
        if req.boots is not None:
            # a handoff: its prefix ran on a prefill replica; the geometry is
            # checked against the pool, then its rows admit as a local
            # prefix's do
            self._ensure_pool(*self._geometry((req.boots, req.pes)))
            return
        d = self._draft
        if self._pcache is not None:
            # per-ROW keys over the raw feed: an entry is shared whatever
            # the request's other rows
            keys = [prefix_row_key(self.engine.fingerprint, req.feed, r)
                    for r in range(req.rows)]
            req.cache_keys = keys
            ents = [self._pcache.get(k) for k in keys]
            hits = sum(e is not None for e in ents)
            if hits:
                self.metrics.counter_inc("gen_prefix_hits_total", by=float(hits))
            if req.rows - hits:
                self.metrics.counter_inc("gen_prefix_misses_total", by=float(req.rows - hits))
            if hits == req.rows and self._state is not None and (d is None
                                                                 or d.mems is not None):
                # every row cached: admitted from the entries, no prefix run
                if obs_trace._armed:
                    obs_trace.instant("gen.prefix_hit", cat="gen", request_id=req.request_id,
                                      rows=req.rows)
                req.cached = ents
                return
            # any miss: the padded prefix runs for every row anyway, so hit
            # rows admit from the fresh states and missing rows are inserted
        with obs_trace.span("gen.prefix", cat="gen", request_id=req.request_id, rows=req.rows):
            target, draft = self._prefix(req.feed)
        self._ensure_pool(*self._geometry(target))
        req.boots, req.pes = target
        if draft is not None:
            self._ensure_draft_pool(*self._geometry(draft))
            req.dboots, req.dpes = draft
        if self._pcache is not None:
            for r in range(req.rows):
                if req.cache_keys[r] not in self._pcache:
                    self._cache_insert(req, r)

    @staticmethod
    def _q_row(x: torch.Tensor):
        """Per-tensor symmetric int8 (the quant recipe: absmax/127, round,
        clip) of one row's state, its scale left on the device."""
        xf = x.float()
        scale = torch.clamp(xf.abs().max(), min=1e-30) / INT8_MAX
        return torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX).to(torch.int8), scale

    def _cache_insert(self, req: _GenRequest, row: int) -> None:
        """One row's prefix state (the target's and the draft's) into the
        device LRU: fp copies, or int8 payloads and per-tensor scales."""
        parts = {"t": (req.boots, req.pes)}
        if self._draft is not None:
            parts["d"] = (req.dboots, req.dpes)
        payload, nbytes = {"d": None}, 0
        for key, (boots, pes) in parts.items():
            tb = tuple(b[row].clone() for b in boots)
            tp = tuple(p[row].clone() for p in pes)
            if self.prefix_cache_quant == "int8":
                pay = (tuple(self._q_row(x) for x in tb), tuple(self._q_row(x) for x in tp))
                nbytes += sum(q.numel() * q.element_size() + sc.element_size()
                              for part in pay for q, sc in part)
            else:
                pay = (tb, tp)
                nbytes += sum(x.numel() * x.element_size() for part in pay for x in part)
            payload[key] = pay
        evicted = self._pcache.put(req.cache_keys[row], payload, nbytes)
        if evicted:
            self.metrics.counter_inc("gen_prefix_cache_evictions_total", by=float(evicted))

    def _cached_rows(self, pay, mem_specs, pe_specs):
        """A cache entry's (boots, per-example rows), int8 ones dequantized
        (q * scale in f32, then the state's dtype)."""
        if self.prefix_cache_quant != "int8":
            return pay
        boots, pes = pay
        return (tuple((q.float() * sc).to(dt) for (q, sc), (_, dt) in zip(boots, mem_specs)),
                tuple((q.float() * sc).to(dt) for (q, sc), (_, dt) in zip(pes, pe_specs)))

    def _admit_row(self, req: _GenRequest, row: int, slot: int) -> None:
        """One request row into a free slot: device copies into the pool's
        buffers, and into the draft's slot state (no host read, no fence)."""
        d = self._draft
        if req.boots is None:  # an all-hit request: from the cache
            ent = req.cached[row]
            boots, pes = self._cached_rows(ent["t"], self._mem_specs, self._pe_specs)
            if d is not None:
                dboots, dpes = self._cached_rows(ent["d"], d.mem_specs, d.pe_specs)
        else:
            boots = tuple(b[row] for b in req.boots)
            pes = tuple(p[row] for p in req.pes)
            if d is not None:
                dboots = tuple(b[row] for b in req.dboots)
                dpes = tuple(p[row] for p in req.dpes)
        st, K = self._state, self.spec.beam_size
        with self.engine._lock:
            for m, b in zip(st.mems, boots):
                m[slot].copy_(b.expand((K,) + tuple(b.shape)))
            st.tok[slot].fill_(self.spec.bos_id)
            st.scores[slot].copy_(self._init_row)
            st.fin[slot].fill_(False)
            st.step[slot].fill_(0)
            for p, r in zip(st.pe, pes):
                p[slot * K:(slot + 1) * K].copy_(r.expand((K,) + tuple(r.shape)))
            # the trellis stays stale: steps overwrite columns 0..t-1
            # before retirement backtracks them
            if d is not None:
                for m, b in zip(d.mems, dboots):
                    m[slot].copy_(b)
                d.tok[slot].fill_(d.spec.bos_id)
                for p, r in zip(d.pe, dpes):
                    p[slot].copy_(r)
            self._set_active(slot, True)
        self._slot_req[slot] = (req, row)
        self.admitted_total += 1

    def _set_active(self, slot: int, on: bool) -> None:
        self._active[slot] = on
        self._active_dev[slot:slot + 1].fill_(on)

    def _step_once(self) -> None:
        """One pool step: a token a slot for one host fence."""
        self._run_round((self._pool,))

    def _spec_round(self) -> None:
        """ONE speculative round over the pool: propose (draft_k greedy draft
        steps), verify (up to draft_k pool-step updates a slot), then one
        host fence that streams every applied token: up to draft_k tokens a
        slot for the one fence plain decoding pays a token. A round whose
        proposals all miss moves each slot one plain step."""
        self._run_round((self._propose, self._verify))

    def _run_round(self, steps: Tuple[_GraphStep, ...]) -> None:
        """Runs `steps` under the engine lock, reads the packed state back
        once, and streams each active slot's applied tokens (column 0 counts
        them) from beam 0's trellis. Plain decoding's round is the pool step;
        a speculative round is propose then verify."""
        armed = obs_trace._armed  # the per-token path: guard all trace work
        spec = steps[-1] is self._verify
        K, T = self.spec.beam_size, self.spec.max_len
        n_steps = self.draft_k if spec else 1  # beam steps a slot the device ran
        if armed:
            n_active = int(self._active.sum())
            if spec:
                obs_trace._begin("gen.verify", "gen",
                                 {"round": self.verify_rounds_total, "active": n_active})
            else:
                obs_trace._begin("gen.pool_step", "gen",
                                 {"step": self.steps_total, "active": n_active})
            obs_trace.counter("gen_active_slots", n_active)
        t0 = time.monotonic()
        try:
            # the point engine.predict fires: a failed round fans out, feeds
            # the breaker and frees the pool
            faults.fire("serving.predict", model=self.engine.model_name, path="generate")
            with self.engine._lock, torch.no_grad():
                for step in steps:
                    step.step()
                # the round's one host fence: everything the host reads
                host = self._packed.to("cpu", copy=True).numpy()
        except Exception as e:
            if armed:
                obs_trace._end()
            if self.breaker is not None:
                self.breaker.record_failure()
            what = "speculative verify round" if spec else "generation pool step"
            with self._cond:
                self._abort_inflight_locked(GenerationAborted(
                    f"{what} failed ({type(e).__name__}: {e}); in-flight requests aborted, "
                    "slots recovered; retry"))
            return
        if armed:
            obs_trace._end()
        adv_sum = int(host[:, 0].sum())
        self.dispatches_total += len(steps)
        self.syncs_total += 1
        self.steps_total += n_steps
        self._occupancy_steps += adv_sum  # the productive slot-steps
        self.metrics.counter_inc("gen_steps_total", by=float(n_steps))
        if spec:
            self._verify_lat.observe(time.monotonic() - t0)
            proposed = n_steps * int(self._active.sum())
            self.verify_rounds_total += 1
            self._draft_proposed += proposed
            self._draft_accepted += adv_sum
            self.metrics.counter_inc("gen_verify_rounds_total")
            self.metrics.counter_inc("gen_draft_tokens_total", by=float(proposed))
            self.metrics.counter_inc("gen_draft_accepted_total", by=float(adv_sum))
        best = 3 + K * T  # beam 0's trellis row: the token of each step
        now = time.monotonic()
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            req, row = self._slot_req[slot]
            a, t_new = int(host[slot, 0]), int(host[slot, 2])
            if req.first_token_at is None and req.deadline <= now:
                # a late FIRST token is never streamed
                self._evict_request(req)
                self._aq.expire(req, "deadline exceeded before the first token (warm the "
                                     "engine)")
                continue
            if a <= 0:
                continue  # an active slot always takes a step
            if req.first_token_at is None:
                req.first_token_at = now
                self._first_tok.observe(now - req.submitted_at)
                if armed:
                    obs_trace.instant("gen.first_token", cat="gen",
                                      request_id=req.request_id, slot=slot)
            if req.last_token_at is not None:
                # a speculative round's tokens come as one burst: the
                # interval is a round's there
                self._per_tok.observe(now - req.last_token_at)
            req.last_token_at = now
            self.tokens_total += a
            self.metrics.counter_inc("gen_tokens_total", by=float(a))
            for t in range(t_new - a, t_new):
                req.handle._emit_token(row, t, int(host[slot, best + t]))
            if host[slot, 1] or t_new >= T:
                self._retire(slot, req, row, t_new, host[slot])

    def _retire(self, slot: int, req: _GenRequest, row: int, t_star: int,
                packed: np.ndarray) -> None:
        """Early exit: backtrack THIS slot's trellis over its own t* steps
        from the step's readback, deliver, and free the slot."""
        K, T = self.spec.beam_size, self.spec.max_len
        with obs_trace.span("gen.retire", cat="gen", request_id=req.request_id, slot=slot,
                            steps=t_star):
            parents = packed[3:3 + K * T].reshape(K, T)
            toks = packed[3 + K * T:3 + 2 * K * T].reshape(K, T)
            scores = packed[3 + 2 * K * T:].view(np.float32)
            req.results[row] = _finalize_slot(parents, toks, scores, t_star, self.spec)
        with self.engine._lock:
            self._set_active(slot, False)
        self._slot_req[slot] = None
        req.live_rows -= 1
        self.retired_total += 1
        if len(req.results) == req.rows and not req.failed:
            outs = {name: np.stack([req.results[r][i] for r in range(req.rows)])
                    for i, name in enumerate(("ids", "scores", "lengths"))}
            if self.breaker is not None:
                self.breaker.record_success()
            req.handle._finish(outs)

    # -- failure paths --------------------------------------------------
    def _evict_request(self, req: _GenRequest) -> None:
        for slot in range(self.max_slots):
            if self._active[slot] and self._slot_req[slot] is not None \
                    and self._slot_req[slot][0] is req:
                self._set_active(slot, False)
                self._slot_req[slot] = None
                req.live_rows -= 1
        if self._partial is req:
            self._partial = None

    def _abort_inflight_locked(self, exc: Exception) -> None:
        """Frees every slot, then fails the requests that held them: a
        client woken by its failure finds the pool already recovered."""
        reqs = {}
        for slot in range(self.max_slots):
            entry = self._slot_req[slot]
            if entry is not None:
                reqs.setdefault(id(entry[0]), entry[0])
            self._slot_req[slot] = None
            if self._active[slot]:
                self._set_active(slot, False)
        if self._partial is not None:
            reqs.setdefault(id(self._partial), self._partial)
            self._partial = None
        for req in reqs.values():
            req.fail(exc)

    # -- accounting -----------------------------------------------------
    def occupancy(self) -> float:
        """Slot occupancy since start (1.0 = every slot busy every step)."""
        return (self._occupancy_steps / (self.steps_total * self.max_slots)
                if self.steps_total else 0.0)

    def stats(self) -> Dict[str, Any]:
        pool = self._pool
        out = {
            "max_slots": self.max_slots,
            "active_slots": int(self._active.sum()),
            "queue_depth": self._aq.depth(),
            "occupancy": round(self.occupancy(), 4),
            "steps_total": self.steps_total,
            "admitted_total": self.admitted_total,
            "retired_total": self.retired_total,
            "tokens_total": self.tokens_total,
            "dispatches_total": self.dispatches_total,
            "syncs_total": self.syncs_total,
            "prefixes_total": self.prefixes_total,
            "prefills_total": self.prefills_total,
            "handoffs_admitted_total": self.handoffs_admitted_total,
            "beam_size": self.spec.beam_size,
            "max_len": self.spec.max_len,
            "pool_step": pool.counts() if pool else {
                "captures": 0, "replays": 0, "eager_steps": 0, "capture_s": 0.0},
        }
        if self._pcache is not None:
            pc = self._pcache.stats()
            pc["quant"] = self.prefix_cache_quant or "fp"
            out["prefix_cache"] = pc
        if self._draft is not None:
            idle = {"captures": 0, "replays": 0, "eager_steps": 0, "capture_s": 0.0}
            out["speculative"] = {
                "draft_dir": self._draft.dir,
                "draft_k": self.draft_k,
                "verify_rounds_total": self.verify_rounds_total,
                "proposed_total": self._draft_proposed,
                "accepted_total": self._draft_accepted,
                "accept_rate": (round(self._draft_accepted / self._draft_proposed, 4)
                                if self._draft_proposed else 0.0),
                "propose_step": self._propose.counts() if self._propose else idle,
                "verify_step": self._verify.counts() if self._verify else idle,
            }
        return out


def _finalize_slot(parents: np.ndarray, toks: np.ndarray, scores: np.ndarray, t_star: int,
                   spec):
    """Backtrack and finalize ONE retired slot: numpy's mirror of
    beam_common.backtrack + finalize over t* steps.

    Equal to the batch op's answer bit for bit: past the step where every
    beam finished, the op's expand and prune is the identity (finished beams
    emit EOS at zero cost, top-K keeps the descending order), so columns t*
    .. T-1 of its trellis backtrack to EOS and the scores never change:
    padding with eos_id gives the full-T result. Integer gathers and the
    length-normalizing f32 division round alike in numpy and torch."""
    K = parents.shape[0]
    T = spec.max_len
    ids = np.full((K, T), spec.eos_id, np.int32)
    idx = np.arange(K)
    for t in range(t_star - 1, -1, -1):
        ids[:, t] = toks[idx, t]
        idx = parents[idx, t]
    is_eos = ids == spec.eos_id
    lengths = np.where(is_eos.any(axis=-1), is_eos.argmax(axis=-1) + 1, T).astype(np.int32)
    scores = scores.astype(np.float32)
    if spec.length_normalize:
        scores = scores / np.maximum(lengths, 1).astype(scores.dtype)
        order = np.argsort(-scores, kind="stable")
        scores, ids, lengths = scores[order], ids[order], lengths[order]
    return ids, scores, lengths
