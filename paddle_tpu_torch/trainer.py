"""Training loop: pass and batch loops, events, testing, checkpoint
cadence (paddle_tpu/trainer.py:78-1228).

One Trainer drives a (main, startup) program pair over a reader. Each step
is one `Executor.run` of the main program, or with `scan_window=K` one
step of an `Executor.run_window` over K batches; the test program is
`main.clone(for_test=True)`. Checkpoints hold every persistable (optimizer
state included) and the reader's position, so a preempted run resumes
mid-pass, from this package's checkpoints or the JAX package's.

The step loop keeps the card ahead of the host:

- fetches stay on the card (`Executor.run(return_numpy=False)`) and fold
  into an on-device accumulator (`core.executor.accum_fold`); the host
  reads it back every `sync_every` steps and at pass end. Each read is a
  device-to-host copy on a side stream after an event recorded on the
  compute stream, then a wait on that copy alone;
- batches arrive through a `DevicePrefetcher` (pinned memory, a side
  stream of its own) by default;
- a checkpoint snapshot hands the scope's tensors to one background
  writer thread, which copies them to the host on its own side stream and
  commits npz + sha256 + atomic rename; the loop waits only if the
  previous commit is still in flight. The per-step loop's snapshot takes
  the tensors by reference: the port's update ops replace tensors rather
  than writing into them (ops/optimizer_ops.py:1-8, ops/nn_ops.py
  `update_running`), so a later step leaves the named step's values
  untouched. A window leaves its own buffers in the scope and the next
  window writes them again (core/graph.py), so under scan_window the
  snapshot copies them on the card first, ordered before the next window;
- EndIteration carries a lazy cost between syncs: a handler that reads
  it pays the sync, a handler that does not pays nothing.

With `scan_window=K` (`_scan_pass`, paddle_tpu/trainer.py:943-1080) the
prefetcher stacks up to K batches of one feed signature and one
`Executor.run_window` runs them: on the card one training step captured as
a CUDA graph and replayed for each, the accumulator folded inside. Host
syncs fall on window edges on the sync_every cadence, checkpoints on the
window edges that cross their interval; a StepGuard in cool-down runs
windows of 1; stop() and SIGTERM finish the window in flight; with
show_param_stats_period set the per-step loop runs, with a warning.

`host_sync_count` counts every device-to-host wait the loop pays and
`host_dispatch_count` every `Executor.run` or `run_window` it issues, as
the JAX package counts them. Sharded checkpoints are not ported yet
(ROADMAP.md, queue A, A10).
"""

from __future__ import annotations

import logging
import math
import queue
import signal
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import io
from . import profiler
from .core.executor import Executor, Scope, accum_fold, global_scope
from .core.lod import LoDArray
from .core.program import (Program, Variable, default_main_program,
                           default_startup_program, grad_var_name)
from .data.feeder import DataFeeder, DevicePrefetcher
from .flags import FLAGS
from .obs import metrics as obs_metrics
from .obs import trace as obs_trace
from .resilience import NonFiniteError, PreemptedError, faults
from .resilience.guard import StepGuard

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration", "CheckpointConfig",
           "Trainer"]


# -- events (python/paddle/v2/event.py) -------------------------------------

class BeginPass:
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass:
    def __init__(self, pass_id: int, metrics: Dict[str, float]):
        self.pass_id = pass_id
        self.metrics = metrics


class BeginIteration:
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration:
    """cost/metrics are plain floats on a per-step sync cadence and
    _LazyScalar wrappers otherwise: float()/format()/comparison/numpy
    coercion read them transparently, so handlers keep working, and a
    handler that never touches them never waits for the card."""

    def __init__(self, pass_id, batch_id, step, cost, metrics):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.step = step  # global step
        self.cost = cost
        self.metrics = metrics


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _HostReader:
    """Device-to-host reads off the compute stream: the copies run on a
    side stream of the reader's own after an event (recorded on the
    caller's current stream unless given), into pinned memory, and the
    host waits on that copy's event alone. On the CPU a read is a view."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream: Optional[torch.cuda.Stream] = None

    def read(self, tensors: Sequence[torch.Tensor], after=None) -> List[np.ndarray]:
        tensors = [t.detach() for t in tensors]
        if self.device.type != "cuda":
            return [_numpy(t) for t in tensors]
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if after is None:
            after = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(after)
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(hosts, tensors):
                h.copy_(t, non_blocking=True)
            done = self._stream.record_event()
        done.synchronize()
        return [_numpy(h) for h in hosts]


class _LazyScalar:
    """A scalar fetch still on the card. Reading it (float, format, str,
    comparison, numpy coercion) is a host sync, so the loop hands these
    to event handlers instead of reading eagerly."""

    __slots__ = ("_value", "_host", "_on_sync", "_reader", "_index")

    def __init__(self, value, on_sync: Optional[Callable] = None,
                 reader: Optional[_HostReader] = None, index: Optional[int] = None):
        self._value = value
        self._host: Optional[float] = None
        self._on_sync = on_sync
        self._reader = reader
        # row `index` of a window's stacked fetch, taken when read: slicing
        # at construction would launch a device op a step
        self._index = index

    def materialize(self) -> float:
        if self._host is None:
            if self._on_sync is not None:
                self._on_sync()
            if self._reader is not None:
                (v,) = self._reader.read([self._value])
            else:
                v = _numpy(torch.as_tensor(self._value).detach().cpu())
            self._host = float(v if self._index is None else v[self._index])
            self._value = None  # drop the device reference once read
        return self._host

    def __float__(self):
        return self.materialize()

    def __format__(self, spec):
        return format(self.materialize(), spec)

    def __str__(self):
        return str(self.materialize())

    def __repr__(self):
        if self._host is None:
            return "<lazy device scalar (unread)>"
        return repr(self._host)

    def __array__(self, dtype=None, copy=None):  # np.isfinite(event.cost) etc.
        return np.asarray(self.materialize(), dtype=dtype)

    def __eq__(self, other):
        return self.materialize() == float(other)

    def __lt__(self, other):
        return self.materialize() < float(other)

    def __le__(self, other):
        return self.materialize() <= float(other)

    def __gt__(self, other):
        return self.materialize() > float(other)

    def __ge__(self, other):
        return self.materialize() >= float(other)

    def __hash__(self):
        return hash(self.materialize())

    def __add__(self, other):
        return self.materialize() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.materialize() - other

    def __rsub__(self, other):
        return other - self.materialize()

    def __mul__(self, other):
        return self.materialize() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.materialize() / other

    def __rtruediv__(self, other):
        return other / self.materialize()


class _PassStats:
    """Per-pass cost/metric accumulation with explicit host-sync points:
    the state lives on the executor's device, `update` folds one step in
    (a few tiny kernels, no host read), `sync` is THE device-to-host read.
    The host-side counts (steps seen, bad seen) feed the StepGuard's window
    observation."""

    def __init__(self, n_metrics: int, skip_nonfinite: bool, device: torch.device,
                 reader: _HostReader, on_sync: Optional[Callable] = None):
        self.skip_nonfinite = bool(skip_nonfinite)
        self.on_sync = on_sync
        self.reader = reader
        self.steps = 0         # steps folded in
        self.synced_steps = 0  # steps whose outcome the host has seen
        self.synced_bad = 0
        self.host = (0, 0.0, [0.0] * n_metrics, 0)  # (n, Σcost, Σm, bad)
        z = torch.zeros((), dtype=torch.int32, device=device)
        zf = torch.zeros((), dtype=torch.float32, device=device)
        self.state = (z, zf, [zf] * n_metrics, z)

    def update(self, cost, metrics) -> None:
        self.steps += 1
        self.state = accum_fold(self.state, cost, list(metrics), self.skip_nonfinite)

    def absorb_window(self, new_state, k: int) -> None:
        """A window folded k steps into the accumulator inside its steps:
        adopt the returned state. No dispatch, no sync."""
        self.state = new_state
        self.steps += int(k)

    def pending(self) -> int:
        return self.steps - self.synced_steps

    def note_observed(self, bad: bool) -> None:
        """A per-step sync already told the guard about this step: advance
        the window markers so the next cadence sync does not report it
        again."""
        self.synced_steps += 1
        if bad:
            self.synced_bad += 1

    def sync(self):
        """Read the accumulator back (the sanctioned sync) and return
        (n_good, n_bad) for the window since the previous sync."""
        if self.on_sync is not None:
            self.on_sync()
        n, cs, ms, bad = self.state
        vals = self.reader.read([n, cs, *ms, bad])
        self.host = (int(vals[0]), float(vals[1]), [float(v) for v in vals[2:-1]],
                     int(vals[-1]))
        delta_total = self.steps - self.synced_steps
        # clamp so a bad verdict from a stats step never pushes the window
        # delta negative
        delta_bad = min(max(0, self.host[3] - self.synced_bad), delta_total)
        self.synced_steps = self.steps
        self.synced_bad = self.host[3]
        return delta_total - delta_bad, delta_bad

    def pass_metrics(self, metric_names: Sequence[str]) -> Dict[str, float]:
        n, cost_sum, msums, _ = self.host
        out = {"cost": cost_sum / n if n else float("nan")}
        denom = max(n, 1)
        for k, s in zip(metric_names, msums):
            out[k] = s / denom
        return out


def _is_float(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating)


def _poison_feed(feed: Dict[str, Any]) -> Dict[str, Any]:
    """faults `executor.step` action=corrupt: NaN-poison the first feed
    slot (in name order) holding floating values: the test's stand-in for
    a bad batch or an overflowed loss."""
    out = dict(feed)
    for k in sorted(out):
        v = out[k]
        if isinstance(v, LoDArray) and _is_float(v.data):
            out[k] = v.with_data(v.data * float("nan"))
            return out
        if _is_float(v):
            out[k] = v * np.float32(np.nan) if isinstance(v, np.ndarray) else v * float("nan")
            return out
    return out


def _poison_window_slot(feed: Dict[str, Any], i: int) -> Dict[str, Any]:
    """_poison_feed for a window: NaN-poison step i of the first feed slot
    (in name order) holding floating values, and no other step."""
    out = dict(feed)
    for k in sorted(out):
        v = out[k]
        t = v.data if isinstance(v, LoDArray) else v
        if _is_float(t):
            t = t.clone()
            t[i] = t[i] * float("nan")
            out[k] = v.with_data(t) if isinstance(v, LoDArray) else t
            return out
    return out


class _CheckpointWriter:
    """The single background checkpoint committer. `submit` waits for the
    PREVIOUS commit first: at most one snapshot is being written while the
    next is taken, so the cadence never queues unbounded host copies. A
    failed commit surfaces on the training thread at the next
    submit/drain."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.commits = 0
        self.failures = 0

    def _loop(self):
        while True:
            fn = self._q.get()
            if fn is None:  # stop(): the thread ends with its train() call
                return
            try:
                fn()
                self.commits += 1
            except BaseException as e:  # surfaced on the training thread
                self.failures += 1
                self._exc = e
            finally:
                self._idle.set()

    def submit(self, fn: Callable[[], Any]) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ptt-ckpt-writer")
            self._thread.start()
        self.drain()  # block only if the previous commit is in flight
        # the submitting thread's correlation ids (the step) go with the
        # commit, so its span links to the step that snapshotted it
        ctx = obs_trace.get_context() if obs_trace._armed else None
        inner = fn

        def fn():
            if ctx is not None:
                obs_trace.set_context(**ctx)
            with profiler.timer("checkpointCommit"):  # host copy + disk commit
                inner()

        self._idle.clear()
        self._q.put(fn)

    def drain(self) -> None:
        """Wait until no commit is in flight; re-raise a failed one."""
        self._idle.wait()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("background checkpoint write failed") from exc

    def stop(self) -> None:
        """End the thread once no commit is in flight (a failed commit stays
        for the next drain); the next submit starts a new one. A Trainer's
        writer lives for one train() call, not for the process."""
        if self._thread is None:
            return
        self._idle.wait()
        self._q.put(None)
        self._thread.join()
        self._thread = None


class CheckpointConfig:
    """Cadence flags (Gen-1 `saving_period`/`saving_period_by_batches`/
    `save_dir`, Trainer.cpp:60-64). background=True hands the host copy and
    the disk commit to the writer thread; the loop pays only for taking
    the tensors' references."""

    def __init__(self, checkpoint_dir: str, epoch_interval: int = 1, step_interval: int = 0,
                 max_num_checkpoints: int = 3, sharded: bool = False,
                 background: bool = True):
        if sharded:
            raise io._sharded_not_ported()
        self.checkpoint_dir = checkpoint_dir
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.max_num_checkpoints = max_num_checkpoints
        self.sharded = sharded
        self.background = background


class Trainer:
    """Drives training of `cost` over a reader.

    The reader yields batches of sample tuples aligned with `feed_order`
    (a DataFeeder converts them), or, with `feed_order=None`, ready feed
    dicts. `place` is the executor's device: the card unless "cpu" is
    named (it raises where there is no card, as Executor does)."""

    def __init__(self, cost: Variable, main_program: Optional[Program] = None,
                 startup_program: Optional[Program] = None, place=None,
                 scope: Optional[Scope] = None,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 executor: Optional[Executor] = None, step_guard: Optional[StepGuard] = None):
        self.cost = cost
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.scope = scope or global_scope()
        self.exe = executor or Executor(place)
        self.device = self.exe.device
        self.test_program = self.main_program.clone(for_test=True)
        self.checkpoint_config = checkpoint_config
        if step_guard is None and FLAGS.step_guard:
            step_guard = StepGuard()
        self.step_guard = step_guard
        self._stop = False
        self._preempt_signal: Optional[int] = None
        self.step = 0  # global batch counter across passes
        self.start_pass = 0
        self._resume_batch = 0  # first batch to run in the resumed pass
        self._initialized = False
        self._ckpt_writer = _CheckpointWriter()
        self._reader = _HostReader(self.device)
        self._writer_reader = _HostReader(self.device)  # the writer thread's stream
        # every sanctioned device-to-host wait (per-step reads, cadence
        # syncs, lazy-cost reads) and every Executor.run of the step loop
        self.host_sync_count = 0
        self.host_dispatch_count = 0
        self._snapshot_copies = False
        self._register_obs_gauges()

    def _register_obs_gauges(self) -> None:
        """Publish the trainer's counters into the process-wide metrics
        registry, through a weakref so a dead trainer's series disappear;
        a newer trainer takes the names over."""
        reg = obs_metrics.registry()
        ref = weakref.ref(self)

        def read(fn):
            def _get():
                t = ref()
                return None if t is None else float(fn(t))
            return _get

        reg.gauge("pt_trainer_step", read(lambda t: t.step),
                  help="global step counter of the live trainer")
        reg.gauge("pt_trainer_dispatches_total", read(lambda t: t.host_dispatch_count),
                  help="Executor.run calls issued by the step loop")
        reg.gauge("pt_trainer_syncs_total", read(lambda t: t.host_sync_count),
                  help="device-to-host waits paid by the step loop")
        reg.gauge("pt_ckpt_commits_total", read(lambda t: t._ckpt_writer.commits),
                  help="background checkpoint commits completed")
        reg.gauge("pt_ckpt_failures_total", read(lambda t: t._ckpt_writer.failures),
                  help="background checkpoint commits that failed")
        reg.gauge("pt_guard_skipped_total",
                  read(lambda t: t.step_guard.skipped if t.step_guard else 0),
                  help="non-finite steps skipped by the StepGuard")
        reg.gauge("pt_guard_rollbacks_total",
                  read(lambda t: t.step_guard.rollbacks if t.step_guard else 0),
                  help="StepGuard checkpoint rollbacks performed")

    def _log_stats(self) -> None:
        g = self.step_guard.stats() if self.step_guard is not None else {}
        logging.getLogger("paddle_tpu_torch.stats").info(
            "step=%d dispatches=%d syncs=%d ckpt_commits=%d ckpt_failures=%d "
            "guard_skipped=%d guard_rollbacks=%d trace_dropped=%d",
            self.step, self.host_dispatch_count, self.host_sync_count,
            self._ckpt_writer.commits, self._ckpt_writer.failures,
            g.get("skipped", 0), g.get("rollbacks", 0), obs_trace.dropped_total())

    def _maybe_log_stats(self, k: int = 1) -> None:
        """The stats line, where the last k steps crossed a multiple of
        FLAGS.stats_period (host-side ints only)."""
        sp = FLAGS.stats_period
        if sp and (self.step // sp) > ((self.step - k) // sp):
            self._log_stats()

    # -- lifecycle ---------------------------------------------------------
    def init(self) -> "Trainer":
        """Run the startup program (parameter init), or resume from the
        newest checkpoint when checkpoint_config points at one."""
        self.exe.run_startup(self.startup_program, scope=self.scope)
        cc = self.checkpoint_config
        if cc and io.get_latest_checkpoint_serial(cc.checkpoint_dir) >= 0:
            args = io.load_checkpoint(cc.checkpoint_dir, self.main_program, self.scope,
                                      device=self.device)
            self.step = int(args.get("step", 0))
            if args.get("mid_pass"):
                # a step_interval checkpoint: re-enter the pass and skip
                # the batches already trained (deterministic readers replay)
                self.start_pass = int(args.get("pass_id", 0))
                self._resume_batch = int(args.get("batch_id", -1)) + 1
            else:
                self.start_pass = int(args.get("pass_id", -1)) + 1
        self._initialized = True
        return self

    def stop(self):
        """Callable from an event handler to end training (v2 trainer.stop)."""
        self._stop = True

    def _count_sync(self) -> None:
        self.host_sync_count += 1

    def _resolve_sync_every(self, log_interval: Optional[int]) -> int:
        """Explicit `log_interval` wins, then FLAGS.sync_every, then auto:
        a StepGuard-armed run keeps the per-step check, everything else
        follows log_period."""
        if log_interval is not None:
            return max(1, int(log_interval))
        if FLAGS.sync_every > 0:
            return int(FLAGS.sync_every)
        if self.step_guard is not None:
            return 1
        return max(1, int(FLAGS.log_period))

    # -- training ----------------------------------------------------------
    def train(self, reader: Callable, num_passes: int,
              feed_order: Optional[Sequence[Variable]] = None,
              event_handler: Optional[Callable] = None,
              fetch_metrics: Optional[Dict[str, Variable]] = None,
              test_reader: Optional[Callable] = None,
              prefetch_to_device: Optional[int] = None,
              log_interval: Optional[int] = None,
              scan_window: Optional[int] = None) -> Dict[str, float]:
        """Pass/batch loop. Returns the final EndPass metrics dict.

        prefetch_to_device is the DevicePrefetcher's depth (default
        FLAGS.prefetch_to_device, 2; 0 feeds the executor from the
        reader directly). log_interval is the host-sync cadence: cost and
        metrics accumulate on the card and are read back every
        `log_interval` steps and at pass end (default: FLAGS.sync_every,
        then log_period; 1 is the synchronous loop). scan_window > 0
        raises NotImplementedError (ROADMAP.md, A6c).

        Preemption: while training runs on the main thread, SIGTERM and
        SIGINT finish the current batch, write an emergency mid-pass
        checkpoint (when checkpoint_config is set), drain the writer and
        raise PreemptedError. Resume rides `init()`."""
        if not self._initialized:
            self.init()
        self._stop = False
        self._preempt_signal = None
        installed: Dict[int, Any] = {}
        if threading.current_thread() is threading.main_thread():
            def _on_preempt(signum, frame):
                self._preempt_signal = signum
                self._stop = True

            for s in (signal.SIGTERM, signal.SIGINT):
                try:
                    installed[s] = signal.signal(s, _on_preempt)
                except (ValueError, OSError):
                    pass
        try:
            return self._train(reader, num_passes, feed_order, event_handler, fetch_metrics,
                               test_reader, prefetch_to_device, log_interval, scan_window)
        finally:
            self._ckpt_writer.stop()
            for s, h in installed.items():
                signal.signal(s, h)

    # the ONLY per-step device-to-host read
    def _host_read_step(self, cost_dev, metric_devs) -> tuple:
        self._count_sync()
        vals = self._reader.read([cost_dev, *metric_devs])
        return float(vals[0]), [float(v) for v in vals[1:]]

    def _resolve_scan_window(self, scan_window: Optional[int]) -> int:
        """The window's K: an explicit `scan_window`, then
        FLAGS.scan_window; 0 is the per-step loop."""
        k = scan_window if scan_window is not None else FLAGS.scan_window
        return max(0, int(k))

    def _train(self, reader, num_passes, feed_order, event_handler, fetch_metrics, test_reader,
               prefetch_to_device, log_interval, scan_window=None) -> Dict[str, float]:
        handler = event_handler or (lambda e: None)
        feeder = DataFeeder(feed_order) if feed_order is not None else None
        metric_items = sorted((fetch_metrics or {}).items())
        metric_names = [k for k, _ in metric_items]
        fetch_list = [self.cost] + [v for _, v in metric_items]
        last_metrics: Dict[str, float] = {}
        guard = self.step_guard
        if prefetch_to_device is None:
            prefetch_to_device = FLAGS.prefetch_to_device
        sync_every = self._resolve_sync_every(log_interval)
        scan_k = self._resolve_scan_window(scan_window)
        log = logging.getLogger("paddle_tpu_torch.trainer")
        if scan_k and not getattr(self.exe, "scan_window_supported", False):
            log.warning("scan_window=%d requested but %s does not run step windows: the "
                        "per-step loop runs", scan_k, type(self.exe).__name__)
            scan_k = 0
        if scan_k and FLAGS.show_param_stats_period:
            log.warning("scan_window disabled: show_param_stats_period needs per-step "
                        "gradient fetches the window does not surface")
            scan_k = 0
        # a window leaves its buffers in the scope, written again by the next
        # window: a checkpoint snapshot copies them
        self._snapshot_copies = bool(scan_k)

        for pass_id in range(self.start_pass, num_passes):
            handler(BeginPass(pass_id))
            acc = _PassStats(len(metric_items), skip_nonfinite=guard is not None,
                             device=self.device, reader=self._reader,
                             on_sync=self._count_sync)
            skip_until = self._resume_batch
            self._resume_batch = 0  # only the resumed pass skips
            if scan_k:
                last_batch_id, interrupted_mid_pass = self._scan_pass(
                    pass_id, reader, feeder, scan_k, acc, fetch_list, metric_names, handler,
                    guard, sync_every, skip_until, prefetch_to_device)
            else:
                last_batch_id, interrupted_mid_pass = self._step_pass(
                    pass_id, reader, feeder, acc, fetch_list, metric_names, handler, guard,
                    sync_every, skip_until, prefetch_to_device)
            # pass end: read whatever the cadence has not yet
            with profiler.timer("hostSync"):
                n_good, n_bad = acc.sync()
            if guard is not None and not guard.observe_window(n_good, n_bad,
                                                               scope=self.scope):
                if guard.wants_rollback():
                    self._rollback(guard)
            last_metrics = acc.pass_metrics(metric_names)
            if test_reader is not None and self._preempt_signal is None:
                # a preempted run skips the evaluation pass: the grace window
                # before SIGKILL is for the emergency checkpoint
                test_metrics = self.test(test_reader, feed_order, fetch_metrics)
                last_metrics.update({f"test_{k}": v for k, v in test_metrics.items()})
            handler(EndPass(pass_id, last_metrics))
            cc = self.checkpoint_config
            if self._stop:
                # interrupted mid-pass: record the batch position so resume
                # re-enters this pass; a stop() from the EndPass handler
                # left the pass complete
                if cc:
                    if interrupted_mid_pass:
                        self._save_checkpoint(pass_id, batch_id=last_batch_id)
                    else:
                        self._save_checkpoint(pass_id)
                break
            if cc and cc.epoch_interval and (pass_id + 1) % cc.epoch_interval == 0:
                self._save_checkpoint(pass_id)
        # every submitted checkpoint is durable before completion is
        # reported, and before PreemptedError hands the job back
        self._ckpt_writer.drain()
        if self._preempt_signal is not None:
            try:
                signame = signal.Signals(self._preempt_signal).name
            except ValueError:
                signame = f"signal {self._preempt_signal}"
            raise PreemptedError(signame, checkpointed=self.checkpoint_config is not None)
        return last_metrics

    def _step_pass(self, pass_id, reader, feeder, acc: _PassStats, fetch_list, metric_names,
                   handler, guard: Optional[StepGuard], sync_every: int, skip_until: int,
                   prefetch_to_device: int):
        """One pass of the per-step loop. Returns (last_batch_id,
        interrupted_mid_pass) for the pass-end logic in _train."""
        last_batch_id = -1
        interrupted_mid_pass = False
        if prefetch_to_device:
            batches = iter(DevicePrefetcher(reader, feeder, depth=prefetch_to_device,
                                            device=self.device))
        else:
            batches = reader()
        for batch_id, data in enumerate(batches):
            if self._stop:
                interrupted_mid_pass = True
                break
            last_batch_id = batch_id
            if batch_id < skip_until:
                continue
            self._maybe_log_stats()
            if obs_trace._armed:
                # correlation ids for every span of this step; the prefetch
                # producer tags the same batch index
                obs_trace.set_context(pass_id=pass_id, batch=batch_id, step=self.step + 1)
            handler(BeginIteration(pass_id, batch_id))
            with profiler.timer("prepareBatchData"):
                if prefetch_to_device:
                    feed = data  # converted, and on the device
                else:
                    feed = feeder.feed(data) if feeder else data
            sp = FLAGS.show_param_stats_period
            want_stats = bool(sp) and (self.step + 1) % sp == 0
            step_fetch = list(fetch_list)
            stat_params = []
            if want_stats:
                trained = set()
                for op in self.main_program.global_block().ops:
                    if op.type == "autodiff":
                        trained |= set(op.attrs.get("params", ()))
                stat_params = [p.name for p in self.main_program.parameters()
                               if p.name in trained]
                step_fetch += [grad_var_name(p) for p in stat_params]
            if faults.fire("executor.step", step=self.step) == "corrupt":
                feed = _poison_feed(feed)
            # enqueue only: fetches stay on the card; the timer measures the
            # host's part, the card's time surfaces under hostSync
            with profiler.timer("forwardBackward"):
                outs = self.exe.run(self.main_program, feed=feed, fetch_list=step_fetch,
                                    scope=self.scope, return_numpy=False)
            self.host_dispatch_count += 1
            cost_dev = outs[0]
            grads = None
            if want_stats:
                grads = dict(zip(stat_params, outs[len(fetch_list):]))
                outs = outs[: len(fetch_list)]
                for pname, st in profiler.parameter_stats(self.main_program, self.scope,
                                                          grads=grads).items():
                    print(f"  param {pname}: " + ", ".join(f"{k}={v:.4g}"
                                                         for k, v in st.items()))
            metric_devs = outs[1:]
            acc.update(cost_dev, metric_devs)
            per_step = (sync_every == 1 or want_stats
                        or (guard is not None and guard.in_cooldown()))
            if per_step:
                with profiler.timer("hostSync"):
                    cost, metric_vals = self._host_read_step(cost_dev, metric_devs)
                if guard is not None:
                    ok = guard.observe(cost, grads, scope=self.scope)
                    acc.note_observed(not math.isfinite(cost))
                    if not ok:
                        # the step is consumed (counter, events) but adds
                        # nothing to the pass stats and NEVER triggers the
                        # checkpoint cadence
                        self.step += 1
                        handler(EndIteration(pass_id, batch_id, self.step, cost, {}))
                        if guard.wants_rollback():
                            self._rollback(guard)
                        continue
                self.step += 1
                handler(EndIteration(pass_id, batch_id, self.step, cost,
                                     dict(zip(metric_names, metric_vals))))
            else:
                self.step += 1
                handler(EndIteration(
                    pass_id, batch_id, self.step,
                    _LazyScalar(cost_dev, self._count_sync, self._reader),
                    {k: _LazyScalar(v, self._count_sync, self._reader)
                     for k, v in zip(metric_names, metric_devs)}))
                if acc.pending() >= sync_every:
                    with profiler.timer("hostSync"):
                        n_good, n_bad = acc.sync()
                    if guard is not None and not guard.observe_window(n_good, n_bad,
                                                                       scope=self.scope):
                        if guard.wants_rollback():
                            self._rollback(guard)
                        continue  # a dirty window: no checkpoint either
            cc = self.checkpoint_config
            if cc and cc.step_interval and self.step % cc.step_interval == 0:
                if guard is not None and acc.pending():
                    # the cadence landed between syncs: learn the window's
                    # outcome before persisting anything
                    with profiler.timer("hostSync"):
                        n_good, n_bad = acc.sync()
                    if not guard.observe_window(n_good, n_bad, scope=self.scope):
                        if guard.wants_rollback():
                            self._rollback(guard)
                        continue
                self._save_checkpoint(pass_id, batch_id=batch_id)
        return last_batch_id, interrupted_mid_pass

    def _scan_pass(self, pass_id, reader, feeder, scan_k: int, acc: _PassStats, fetch_list,
                   metric_names, handler, guard: Optional[StepGuard], sync_every: int,
                   skip_until: int, prefetch_to_device: int):
        """One pass of the windowed loop (paddle_tpu/trainer.py:943-1053):
        the DevicePrefetcher stacks up to K batches of one signature, and
        one `Executor.run_window` runs them. The accumulator is folded
        inside the window's steps, so cost, metrics and the non-finite
        count reach the host only at window-edge syncs on the sync_every
        cadence. Checkpoints fall on window edges; a StepGuard in cool-down
        runs windows of 1; stop() and SIGTERM finish the window in
        flight. Returns (last_batch_id, interrupted_mid_pass)."""
        src = reader
        if skip_until:
            # a mid-pass resume: drop the trained batches before windowing,
            # so windows start at the resume point
            def src():
                for i, b in enumerate(reader()):
                    if i >= skip_until:
                        yield b
        # depth counts windows: at least the configured batches, and one
        # window, in flight
        depth = max(1, -(-max(1, prefetch_to_device) // scan_k)) + 1
        windows = iter(DevicePrefetcher(src, feeder, depth=depth, device=self.device,
                                        window=scan_k))
        next_batch = skip_until
        last_batch_id = skip_until - 1
        interrupted_mid_pass = False
        for win in windows:
            if self._stop:
                interrupted_mid_pass = True
                break
            k = win.k
            bids = list(range(next_batch, next_batch + k))
            next_batch += k
            self._maybe_log_stats(k)
            if obs_trace._armed:
                # the window's correlation ids: one forwardBackward span
                # covers steps step+1..step+k
                obs_trace.set_context(pass_id=pass_id, window=bids[0], batch=bids[0],
                                      step=self.step + 1, k=k)
            for b in bids:
                handler(BeginIteration(pass_id, b))
            feed = win.feed
            for i in range(k):
                if faults.fire("executor.step", step=self.step + i) == "corrupt":
                    feed = _poison_window_slot(feed, i)
            dirty = False
            if guard is not None and guard.in_cooldown():
                # step-granular recovery: the window's steps as windows of 1,
                # the guard observing each
                for i in range(k):
                    if not self._scan_one(pass_id, bids[i], win.slice(i), acc, fetch_list,
                                          metric_names, handler, guard):
                        dirty = True
                last_batch_id = bids[-1]
            else:
                with profiler.timer("forwardBackward"):
                    ys, acc_out = self.exe.run_window(
                        self.main_program, feed=feed, fetch_list=fetch_list, scope=self.scope,
                        acc_state=acc.state, skip_nonfinite=acc.skip_nonfinite)
                self.host_dispatch_count += 1
                acc.absorb_window(acc_out, k)
                for i in range(k):
                    self.step += 1
                    handler(EndIteration(
                        pass_id, bids[i], self.step,
                        _LazyScalar(ys[0], self._count_sync, self._reader, index=i),
                        {m: _LazyScalar(v, self._count_sync, self._reader, index=i)
                         for m, v in zip(metric_names, ys[1:])}))
                last_batch_id = bids[-1]
                if acc.pending() >= sync_every:
                    with profiler.timer("hostSync"):
                        n_good, n_bad = acc.sync()
                    if guard is not None and not guard.observe_window(n_good, n_bad,
                                                                       scope=self.scope):
                        dirty = True  # a rollback discards the whole window
                        if guard.wants_rollback():
                            self._rollback(guard)
            cc = self.checkpoint_config
            if dirty or not (cc and cc.step_interval):
                continue
            # the cadence on window edges: one save where any step of the
            # window crossed a multiple of step_interval
            if (self.step // cc.step_interval) > ((self.step - k) // cc.step_interval):
                if guard is not None and acc.pending():
                    with profiler.timer("hostSync"):
                        n_good, n_bad = acc.sync()
                    if not guard.observe_window(n_good, n_bad, scope=self.scope):
                        if guard.wants_rollback():
                            self._rollback(guard)
                        continue  # a dirty window: no checkpoint either
                self._save_checkpoint(pass_id, batch_id=last_batch_id)
        return last_batch_id, interrupted_mid_pass

    def _scan_one(self, pass_id, batch_id, feed, acc: _PassStats, fetch_list, metric_names,
                  handler, guard: StepGuard) -> bool:
        """The StepGuard's cool-down: one step as a window of 1, the
        accumulator read and the guard observing after it. Returns whether
        the step was clean (a dirty one suppresses the window's checkpoint,
        as in the per-step loop)."""
        with profiler.timer("forwardBackward"):
            ys, acc_out = self.exe.run_window(
                self.main_program, feed=feed, fetch_list=fetch_list, scope=self.scope,
                acc_state=acc.state, skip_nonfinite=acc.skip_nonfinite)
        self.host_dispatch_count += 1
        acc.absorb_window(acc_out, 1)
        self.step += 1
        with profiler.timer("hostSync"):
            n_good, n_bad = acc.sync()
        handler(EndIteration(
            pass_id, batch_id, self.step,
            _LazyScalar(ys[0], self._count_sync, self._reader, index=0),
            {m: _LazyScalar(v, self._count_sync, self._reader, index=0)
             for m, v in zip(metric_names, ys[1:])}))
        if not guard.observe_window(n_good, n_bad, scope=self.scope):
            if guard.wants_rollback():
                self._rollback(guard)
            return False
        return True

    # -- testing (paddle/trainer/Tester.cpp; v2 trainer.test) --------------
    def test(self, reader: Callable, feed_order: Optional[Sequence[Variable]] = None,
             fetch_metrics: Optional[Dict[str, Variable]] = None) -> Dict[str, float]:
        feeder = DataFeeder(feed_order) if feed_order is not None else None
        metric_items = sorted((fetch_metrics or {}).items())
        fetch_list = [self.cost] + [v for _, v in metric_items]
        sums = np.zeros(len(fetch_list))
        n = 0
        for data in reader():
            feed = feeder.feed(data) if feeder else data
            outs = self.exe.run(self.test_program, feed=feed, fetch_list=fetch_list,
                                scope=self.scope)
            sums += np.array([float(np.asarray(o)) for o in outs])
            n += 1
        n = max(n, 1)
        out = {"cost": float(sums[0] / n)}
        for i, (k, _) in enumerate(metric_items):
            out[k] = float(sums[i + 1] / n)
        return out

    # -- non-finite recovery (resilience.StepGuard) -------------------------
    def _rollback(self, guard: StepGuard) -> None:
        """K consecutive non-finite steps: restore the newest VALID
        checkpoint and enter the guard's reduced-LR cool-down. Training
        continues from the current reader position."""
        # an in-flight background save may BE the checkpoint to restore
        self._ckpt_writer.drain()
        cc = self.checkpoint_config
        serial = io.get_latest_checkpoint_serial(cc.checkpoint_dir) if cc else -1
        if serial < 0:
            raise NonFiniteError(
                f"{guard.bad_streak} consecutive non-finite steps and no checkpoint to "
                "roll back to (set checkpoint_config to make the StepGuard recoverable)")
        args = io.load_checkpoint(cc.checkpoint_dir, self.main_program, self.scope,
                                  device=self.device)
        self.step = int(args.get("step", self.step))
        guard.after_rollback(self.main_program, self.scope)

    # -- checkpointing ------------------------------------------------------
    def _save_checkpoint(self, pass_id: int, batch_id: Optional[int] = None) -> None:
        cc = self.checkpoint_config
        args = {"pass_id": pass_id, "step": self.step, "time": time.time()}
        if batch_id is not None:
            args.update({"mid_pass": True, "batch_id": batch_id})
        if not cc.background:
            io.save_checkpoint(cc.checkpoint_dir, trainer_args=args,
                               main_program=self.main_program, scope=self.scope,
                               max_num_checkpoints=cc.max_num_checkpoints)
            return
        # the named step's values, by reference (see the module docstring),
        # and an event after the step's work; the writer copies them to the
        # host on its own stream and commits
        with profiler.timer("checkpointSnapshot"):
            names = sorted(v.name for v in self.main_program.persistables()
                           if self.scope.has(v.name))
            refs = [self.scope.get(n) for n in names]
            if self._snapshot_copies:
                # the window's buffers: copied on the card before the next
                # window writes them again
                refs = [r.clone() for r in refs]
            after = (torch.cuda.current_stream(self.device).record_event()
                     if self.device.type == "cuda" else None)
        program, max_keep, reader = self.main_program, cc.max_num_checkpoints, \
            self._writer_reader

        def commit():
            host = Scope()
            for n, v in zip(names, reader.read(refs, after)):
                host.set(n, v)
            io.save_checkpoint(cc.checkpoint_dir, trainer_args=args, main_program=program,
                               scope=host, max_num_checkpoints=max_keep)

        self._ckpt_writer.submit(commit)

    def save_params(self, dirname: str) -> None:
        io.save_params(dirname, self.main_program, self.scope)

    def save_inference_model(self, dirname, feeded_var_names, target_vars):
        io.save_inference_model(dirname, feeded_var_names, target_vars,
                                main_program=self.main_program, scope=self.scope)
