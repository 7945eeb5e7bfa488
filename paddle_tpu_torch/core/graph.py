"""The Trainer's scan window: one training step captured as a CUDA graph and
replayed for each step of a window (the JAX package's
`Executor.run_window` and its window cache,
paddle_tpu/core/executor.py:559-637).

The JAX package compiles a window of K steps into one `lax.scan`. Here
`_StepGraph` captures ONE step with `torch.cuda.CUDAGraph` and `run_window`
replays it once a step of the window. The capture stays the size of one
step, and a short window (the pass's ragged tail) replays the same graph.

- **Key.** As the JAX cache key: the program (its identity, version, amp
  dtype, remat policy and the flags that pick its kernels' routes), `skip_nonfinite`,
  whether an accumulator is carried, the feed signature of ONE step, the
  fetch names and the persistable names. A new key captures anew.
  `Executor.cache_stats` counts hits, misses, captures, replays and the
  steps run eagerly; `Executor._windows` holds the steps.
- **Static buffers.** Each persistable lives in a buffer of the step's own.
  The step ends with `buf.copy_(env[name])` for each persistable it
  replaced, so the update ops (which replace tensors, ops/optimizer_ops.py)
  stay as they are. Slot i of the window's feed is copied into the step's
  feed buffers before step i, and its fetches out of the step's fetch
  buffers into slot i of fresh [K, ...] outputs after it. The accumulator
  (`executor.accum_fold`) is folded inside the step into 0-d buffers.
- **Scope identity.** At a window's start, a scope entry that is not the
  step's buffer (after a StepGuard rollback, a resume, a per-step
  `Executor.run` between windows) is copied into the buffer; after the
  window the scope holds the buffers. A snapshot of them must copy them before the next window
  (trainer.py's checkpoints do).
- **Warm-up, then capture.** The first step of a new key runs eagerly on
  the capture stream as a real training step: it builds the kernels'
  libraries, fills the wrappers' caches (`rnn_kernels._pack_index` reads
  the host) and settles cuDNN's plans. The second step captures, then
  replays; capturing runs nothing, so no step is lost or run twice.
- **Random ops.** The step's generator is registered with its graph and
  re-seeded before every step as `Executor.run` seeds one: from
  `program.random_seed`, else a fresh seed. A window draws the per-step
  loop's numbers. An executor's own step generators (the pipeline's, one
  a micro-batch) are registered too and seeded from the same seed.
- **Launch counters.** The kernel wrappers count their launches in Python
  (`LAUNCH_COUNTERS`); under capture they count once and replays count
  nothing. The capture's change is taken back and added at every replay,
  so launches a step read the same through a window as through the
  per-step loop.
- **No fallback.** A capture that fails raises, naming the op at fault; it
  never runs the step eagerly instead.

On the CPU there is no graph: every step runs eagerly on the same buffers,
fetches and accumulator. That is the path the tests take.
"""

from __future__ import annotations

import importlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..flags import FLAGS
from .executor import _feed_signature, accum_fold
from .lod import LoDArray
from .program import Program, Variable
from .sparse import feed_leaves, feed_like

# the kernel wrappers' launch counters, each an int or a dict of ints by
# route, read and written by module and name
LAUNCH_COUNTERS = (
    ("paddle_tpu_torch.ops.lstm_kernels", ("lstm_fwd_launches", "lstm_bwd_launches")),
    ("paddle_tpu_torch.ops.rnn_kernels", ("gru_fwd_launches", "gru_bwd_launches")),
    ("paddle_tpu_torch.ops.attention_kernels",
     ("attn_fwd_launches", "attn_fwd_paths", "attn_bwd_step_launches", "attn_bwd_step_paths",
      "attn_phase2_launches", "decoder_seq_fwd_launches", "decoder_seq_fwd_routes",
      "decoder_seq_bwd_launches", "decoder_seq_dep_launches")),
    ("paddle_tpu_torch.ops.flash_kernels",
     ("flash_fwd_launches", "flash_bwd_dkv_launches", "flash_bwd_dq_launches")),
    ("paddle_tpu_torch.ops.flash_ops", ("plain_routes",)),
    ("paddle_tpu_torch.ops.fused_conv_kernels",
     ("fused_conv_bn_launches", "fused_conv_bn_input_copies")),
    ("paddle_tpu_torch.ops.quant_kernels", ("quant_matmul_launches", "quant_matmul_routes")),
)


def counter_state() -> Dict[Tuple[str, str], Any]:
    """Every launch counter's value now (dicts copied)."""
    out = {}
    for mod_name, names in LAUNCH_COUNTERS:
        mod = importlib.import_module(mod_name)
        for n in names:
            v = getattr(mod, n)
            out[(mod_name, n)] = dict(v) if isinstance(v, dict) else int(v)
    return out


def counter_delta(before, after) -> Dict[Tuple[str, str], Any]:
    """The counters that moved between two `counter_state`s, by how much."""
    delta = {}
    for key, a in after.items():
        b = before[key]
        if isinstance(a, dict):
            d = {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
            if d:
                delta[key] = d
        elif a != b:
            delta[key] = a - b
    return delta


def counter_add(delta, times: int = 1) -> None:
    """Add `times` x `delta` to the counters."""
    for (mod_name, n), d in delta.items():
        mod = importlib.import_module(mod_name)
        if isinstance(d, dict):
            cur = getattr(mod, n)
            for k, v in d.items():
                cur[k] = cur.get(k, 0) + times * v
        else:
            setattr(mod, n, getattr(mod, n) + times * d)


def _copy_all(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """dst.copy_(src) for each pair, one multi-tensor copy a dtype (a list
    mixing dtypes would fall back to one copy a tensor)."""
    groups: Dict[Tuple[torch.dtype, torch.dtype], Tuple[list, list]] = {}
    for d, src in zip(dsts, srcs):
        g = groups.setdefault((d.dtype, src.dtype), ([], []))
        g[0].append(d)
        g[1].append(src)
    for d, src in groups.values():
        torch._foreach_copy_(d, src)


def _route_flags() -> tuple:
    """The flags that pick the step's kernels' routes (flags.py)."""
    return (FLAGS.use_fused_rnn, FLAGS.use_fused_attention, FLAGS.fused_attention_seq_fwd,
            FLAGS.fused_attention_seq_bwd, FLAGS.fused_conv_dot_max_n, FLAGS.fused_conv_pallas,
            FLAGS.bn_bf16_stats)


class CapturedStep:
    """A step body (`_body`, a subclass's) on fixed buffers: on the card run
    eagerly once on its own stream (`_on_stream`), then captured as a CUDA
    graph (`_capture`) and replayed (`replay`); on the CPU the caller runs
    `_body` itself. `_StepGraph` here and the generation pool step
    (serving/scheduler.py) are its two steps."""

    what = "the step"  # named in a failed capture's error

    def __init__(self, device: torch.device, gen: Optional[torch.Generator] = None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.gen = gen
        self.extra_gens: Tuple[torch.Generator, ...] = ()  # registered with the graph too
        self.graph = None
        self.delta: Dict[Tuple[str, str], Any] = {}  # the counters a step moves
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.capture_s = 0.0

    def _body(self) -> None:
        raise NotImplementedError

    def replay(self) -> None:
        counter_add(self.delta)
        self.graph.replay()

    def _on_stream(self, fn) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def _capture(self) -> None:
        """Capture one step. Capturing runs nothing, so the counters it
        moved are taken back and kept as the step's delta, added at every
        replay."""
        before = counter_state()
        t0 = time.perf_counter()
        try:
            graph = self._record()
        except Exception as e:
            counter_add(counter_delta(counter_state(), before))
            raise RuntimeError(f"capturing {self.what} as a CUDA graph failed: {e}") from e
        self.delta = counter_delta(before, counter_state())
        counter_add(self.delta, -1)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def _record(self):
        """`_body` captured on the capture stream, the generator registered:
        the graph. Other threads' CUDA calls (the prefetcher's copies, the
        checkpoint writer's reads) stay legal meanwhile: the capture's error
        mode is this thread's."""
        graph = torch.cuda.CUDAGraph()
        for gen in (self.gen, *self.extra_gens):
            if gen is not None:
                graph.register_generator_state(gen)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body()
            except BaseException:
                try:  # end the broken capture; the op's error is the one raised
                    graph.capture_end()
                except Exception:
                    pass
                raise
            graph.capture_end()
        cur.wait_stream(self.stream)
        return graph


class _StepGraph(CapturedStep):
    """One training step of `program` on static buffers: eager on the CPU
    and for the first step on the card, then captured and replayed (the
    module docstring)."""

    what = "the training step"

    def __init__(self, exe, program: Program, fetch_names: Sequence[str], skip_nonfinite: bool,
                 with_acc: bool):
        super().__init__(exe.device, torch.Generator(device=exe.device))
        self.extra_gens = tuple(exe._step_generators())
        self.exe = exe
        self.program = program
        self.fetch_names = list(fetch_names)
        self.persist = [v.name for v in program.persistables()]
        self.skip_nonfinite = skip_nonfinite
        self.with_acc = with_acc
        self.bufs: Dict[str, torch.Tensor] = {}  # the persistables
        self.feed: Optional[Dict[str, Any]] = None  # one step's feed
        self.outs: Optional[List[torch.Tensor]] = None  # the fetches' leaves
        self.lod_fetches: List[int] = []  # a LoDArray fetch's leaf count, else 0
        self.acc: List[torch.Tensor] = []  # the accumulator, flat
        self.warm = False

    # -- buffers ------------------------------------------------------------
    def bind(self, scope, step_feed: Dict[str, Any], acc_state) -> None:
        """At a window's start: make the buffers on first use, then copy
        into them every scope entry that is not already its buffer, and the
        accumulator; the scope then holds the buffers."""
        if self.feed is None:
            self.feed = {k: feed_like(v, [torch.empty_like(t) for t in feed_leaves(v)])
                         for k, v in step_feed.items()}
        srcs, dsts = [], []
        for name in self.persist:
            if not scope.has(name):
                continue
            v = scope.get(name)
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"run_window: persistable {name!r} is a "
                                f"{type(v).__name__}, not a tensor")
            if v.device != self.device:
                raise ValueError(f"scope value {name!r} lies on {v.device}, the executor "
                                 f"runs on {self.device}")
            buf = self.bufs.get(name)
            if buf is None:
                buf = self.bufs[name] = torch.empty_like(v)
            elif buf is v:
                continue
            self._check_like(name, buf, v)
            srcs.append(v.detach())
            dsts.append(buf)
            scope.set(name, buf)
        if acc_state is not None:
            flat = [acc_state[0], acc_state[1], *acc_state[2], acc_state[3]]
            if not self.acc:
                self.acc = [torch.empty_like(t) for t in flat]
            srcs += flat
            dsts += self.acc
        _copy_all(dsts, srcs)

    @staticmethod
    def _check_like(name, buf, v):
        if buf.shape != v.shape or buf.dtype != v.dtype:
            raise ValueError(f"run_window: {name!r} is {v.dtype} {tuple(v.shape)} where its "
                             f"buffer is {buf.dtype} {tuple(buf.shape)}")

    def acc_state(self):
        a = self.acc
        return (a[0], a[1], list(a[2:-1]), a[-1])

    # -- the step -------------------------------------------------------------
    def _body(self) -> None:
        """One step on the buffers: the ops, then every persistable the step
        replaced, the fetches and the folded accumulator copied into their
        buffers."""
        env = dict(self.bufs)
        env.update(self.feed)
        self.exe._execute(self.program, env, self.fetch_names, self.persist, self.gen)
        with torch.no_grad():
            self._copy_back(env)

    def _copy_back(self, env) -> None:
        """The step's ends into their buffers, one multi-tensor copy a
        dtype."""
        srcs, dsts = [], []
        for name in self.persist:
            v = env.get(name)
            if not isinstance(v, torch.Tensor):
                continue
            buf = self.bufs.get(name)
            if buf is None:  # a persistable the step made: it gets a buffer
                self.bufs[name] = v.detach().clone()
                continue
            if v.data_ptr() == buf.data_ptr():
                continue
            self._check_like(name, buf, v)
            srcs.append(v.detach())
            dsts.append(buf)
        fetches = [env[n] for n in self.fetch_names]
        leaves = [t.detach() for f in fetches for t in feed_leaves(f)]
        if self.outs is None:
            self.outs = [torch.empty_like(t) for t in leaves]
            self.lod_fetches = [len(feed_leaves(f)) if isinstance(f, LoDArray) else 0
                                for f in fetches]
        srcs += leaves
        dsts += self.outs
        if self.with_acc:
            n, cs, ms, bad = accum_fold(self.acc_state(), fetches[0], fetches[1:],
                                        self.skip_nonfinite)
            srcs += [n, cs, *ms, bad]
            dsts += self.acc
        _copy_all(dsts, srcs)

    def _seed(self) -> None:
        seed = self.program.random_seed or int.from_bytes(os.urandom(4), "little")
        self.gen.manual_seed(int(seed))
        self.exe._seed_step_generators(int(seed))

    def step(self) -> None:
        """One training step: eager on the CPU and for the key's first step
        on the card (on the capture stream), captured at the second, then
        replayed."""
        self._seed()
        if not self.cuda:
            self._body()
            self.exe.cache_stats["eager_steps"] += 1
            return
        if not self.warm:
            self._on_stream(self._body)
            self.warm = True
            self.exe.cache_stats["eager_steps"] += 1
            return
        if self.graph is None:
            self._capture()
            self.exe.cache_stats["captures"] += 1
        self.replay()
        self.exe.cache_stats["replays"] += 1


def _window_key(program: Program, skip_nonfinite: bool, with_acc: bool, step_feed,
                fetch_names, persist_names) -> tuple:
    return (id(program), program.version, program.amp_dtype, program.remat_policy,
            _route_flags(), bool(skip_nonfinite), with_acc, _feed_signature(step_feed),
            tuple(fetch_names), tuple(persist_names))


def run_window(exe, program: Program, feed: Dict[str, Any], fetch_list, scope, acc_state,
               skip_nonfinite: bool):
    """Executor.run_window (core/executor.py)."""
    fetch_names = [v.name if isinstance(v, Variable) else v for v in (fetch_list or [])]
    if acc_state is not None and not fetch_names:
        raise ValueError("run_window with acc_state needs fetch_list[0] = cost")
    feed = {k: exe._to_device(k, v) for k, v in (feed or {}).items()}
    if not feed:
        raise ValueError("run_window needs at least one feed slot")
    ks = {int(t.shape[0]) for v in feed.values() for t in feed_leaves(v)}
    if len(ks) != 1 or 0 in ks:
        raise ValueError(f"run_window: the feeds' leading (window) axes differ or are "
                         f"empty: {sorted(ks)}")
    k_steps = ks.pop()
    slots = [{k: feed_like(v, [t[i] for t in feed_leaves(v)]) for k, v in feed.items()}
             for i in range(k_steps)]
    persist_names = sorted(v.name for v in program.persistables() if scope.has(v.name))
    key = _window_key(program, skip_nonfinite, acc_state is not None, slots[0], fetch_names,
                      persist_names)
    sg = exe._windows.get(key)
    if sg is None:
        exe.cache_stats["misses"] += 1
        sg = exe._windows[key] = _StepGraph(exe, program, fetch_names, skip_nonfinite,
                                            acc_state is not None)
    else:
        exe.cache_stats["hits"] += 1
    sg.bind(scope, slots[0], acc_state)
    feed_bufs = [t for v in sg.feed.values() for t in feed_leaves(v)]
    ys: List[torch.Tensor] = []
    for i, slot in enumerate(slots):
        _copy_all(feed_bufs, [t for k in sg.feed for t in feed_leaves(slot[k])])
        sg.step()
        if not ys:
            ys = [torch.empty((k_steps,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                  for t in sg.outs]
        _copy_all([y[i] for y in ys], sg.outs)
    for name, buf in sg.bufs.items():
        scope.set(name, buf)
    out = []
    for lod in sg.lod_fetches:
        n = lod or 1
        out.append(LoDArray(*ys[:n]) if lod else ys[0])
        ys = ys[n:]
    acc_out = None
    if acc_state is not None:
        a = [t.clone() for t in sg.acc]
        acc_out = (a[0], a[1], a[2:-1], a[-1])
    return out, acc_out
