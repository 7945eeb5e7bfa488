"""ServingEngine: shape-bucketed inference over a saved model
(paddle_tpu/serving/engine.py).

Requests of any batch size are padded up to a small set of batch buckets
(powers of two up to `max_batch_size`), and sequence lengths to an opt-in
list, so all traffic runs at most `len(buckets)` distinct shapes. The JAX
engine buckets to bound its compiled programs; on the card nothing is
compiled, but the same grid bounds the shapes cuBLAS and the hand kernels
see, and the accounting keeps its meaning: a miss is a bucket signature seen
for the first time (its first run), a hit one seen before. The JAX engine's
second level, the Executor's jit cache, has no counterpart: the port's
Executor runs a block eagerly and caches nothing a shape (its
`cache_stats`, shown in `stats()`, count the Trainer's windows).

Padding policy (paddle_tpu/serving/engine.py:326-364):
- batch axis (0): EDGE-replicate the last real row (a zero row could make
  non-finite values in padded lanes);
- sequence axis: ZERO-pad (masked models treat zeros as padding,
  position-wise models never mix positions).
Outputs are cut back to the request's true extents; `bucketed=False` runs
the exact shape, the oracle the bucketed path is held to.

Every `predict` is one dispatch and, since it returns numpy, one host
fence: `dispatches_total` and `syncs_total` count them, as the Trainer's
counters do. A generation model (a `beam_search_group` op) also serves
through `scheduler()`, the continuous-batching ContinuousScheduler.

Left out until their queue items: the mesh replica (`mesh=`, ROADMAP.md A10)
and the autotuner's surfaces (`tune_coverage`, `check_tuned_table`,
`decode_tune_cases`, `tune_decode_kernels`, A11); each raises
NotImplementedError.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import profiler
from ..core.executor import Executor, Scope
from ..core.lod import LoDArray
from ..core.place import resolve_device
from ..io import load_inference_model, program_fingerprint
from ..ops.generation_ops import find_generation_op, gen_spec_from_op
from ..resilience import faults
from .metrics import MetricSet

__all__ = ["BucketPolicy", "ServingEngine"]


def _pow2_buckets(max_batch_size: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue A, {item})")


class BucketPolicy:
    """Quantizes request shapes onto the bounded bucket grid.

    `batch_buckets` defaults to the powers of two up to `max_batch_size`
    (inclusive: a non-power-of-two max is itself the last bucket, so the
    micro-batcher's full batches never re-pad). `seq_len_buckets` is empty
    by default: sequence bucketing is opt-in and applies to feed axis
    `seq_axis` of every array with more than `seq_axis` dimensions."""

    def __init__(self, max_batch_size: int = 64, batch_buckets: Optional[Sequence[int]] = None,
                 seq_len_buckets: Sequence[int] = (), seq_axis: int = 1):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        self.max_batch_size = max_batch_size
        self.batch_buckets = tuple(sorted(
            batch_buckets if batch_buckets is not None else _pow2_buckets(max_batch_size)))
        if not self.batch_buckets:
            raise ValueError("batch_buckets must not be empty")
        self.seq_len_buckets = tuple(sorted(seq_len_buckets))
        self.seq_axis = seq_axis

    def batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request batch {n} exceeds the largest batch bucket {self.batch_buckets[-1]}; "
            "split the request or raise max_batch_size")

    def seq_bucket(self, t: int) -> int:
        for b in self.seq_len_buckets:
            if t <= b:
                return b
        # beyond the grid (or no grid): the exact length, one more shape
        # counted as a miss
        return t

    def max_programs(self, num_seq_lens: int = 0) -> int:
        """Upper bound on distinct shapes for in-grid traffic."""
        s = max(1, len(self.seq_len_buckets)) if num_seq_lens == 0 else num_seq_lens
        return len(self.batch_buckets) * s


class ServingEngine:
    """Owns one loaded model: scope, program, Executor and bucket accounting.

    `device=None` loads onto the card; tests pass `device="cpu"`.
    Thread-safe: `predict` serializes on an internal lock (one request's
    work runs at a time an engine; concurrency above it comes from the
    micro-batcher coalescing requests into a call). The continuous
    scheduler takes the same lock for its device work."""

    def __init__(self, model_dir: str, policy: Optional[BucketPolicy] = None,
                 model_name: str = "default", metrics: Optional[MetricSet] = None,
                 mesh=None, batch_axis: Optional[str] = None, quantize: Optional[str] = None,
                 device=None):
        if mesh is not None or batch_axis is not None:
            raise _not_ported("a mesh-sharded serving replica (mesh=, batch_axis=)", "A10")
        self.model_name = model_name
        self.model_dir = model_dir
        self.policy = policy or BucketPolicy()
        self.device = resolve_device(device)
        self.scope = Scope()
        self.program, self.feed_names, self.fetch_names = load_inference_model(
            model_dir, scope=self.scope, device=self.device)
        # the artifact's identity (/healthz "versions"): the exporter's
        # fingerprint, recomputed for an artifact without one
        self.fingerprint = (getattr(self.program, "_program_fingerprint", None)
                            or program_fingerprint(self.program))
        # quantize="int8" asserts the artifact IS a converted one (its quant
        # sidecar, checked at load): a misrouted fp artifact fails here
        self.quant_meta = getattr(self.program, "_quant_meta", None)
        self.quantize = quantize
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unsupported quantize mode {quantize!r} (only 'int8')")
            if not self.quant_meta:
                raise ValueError(
                    f"model {model_name!r}: quantize='int8' requested but {model_dir} "
                    "carries no quant sidecar: quantize it (quant.calibrate, quant.convert) "
                    "and serve the converted artifact")
            if self.quant_meta.get("mode") != quantize:
                raise ValueError(f"model {model_name!r}: artifact was quantized as "
                                 f"{self.quant_meta.get('mode')!r}, not {quantize!r}")
        self.exe = Executor(device=self.device)
        self.feed_specs: Dict[str, Dict[str, Any]] = {}
        meta = getattr(self.program, "_serving_meta", None)
        for n in self.feed_names:
            spec = (meta or {}).get(n)
            if spec is None:
                try:
                    v = self.program.global_block().var(n)
                    spec = {"dtype": np.dtype(v.dtype).name, "shape": list(v.shape)}
                except KeyError:
                    spec = {"dtype": "float32", "shape": []}
            self.feed_specs[n] = spec
        # the generation sidecar sizes the scheduler's slot pool; the
        # draft sidecar names the scheduler's default speculative draft
        self.generation_meta = getattr(self.program, "_generation_meta", None)
        self.draft_meta = getattr(self.program, "_draft_meta", None)
        gen_op = find_generation_op(self.program)
        self._gen_spec = gen_spec_from_op(gen_op) if gen_op is not None else None
        self._scheduler = None
        self.metrics = metrics or MetricSet(stat_set=profiler.global_stat_set())
        self._lock = threading.RLock()
        self._seen_buckets: Dict[tuple, int] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.dispatches_total = 0
        self.syncs_total = 0
        self._lat = self.metrics.histogram(
            "engine_run_seconds",
            help="end-to-end ServingEngine.predict latency (pad + run + slice)")
        # every counter pre-registered: a scraper never sees one missing
        self.metrics.declare_counter(
            "compile_cache_hits_total",
            help="requests served by a bucket signature seen before")
        self.metrics.declare_counter(
            "compile_cache_misses_total",
            help="requests whose bucket signature ran for the first time")
        self.metrics.declare_counter("dispatches_total",
                                     help="program dispatches issued by this engine")
        self.metrics.declare_counter(
            "syncs_total", help="host fences paid by this engine (numpy fetch per predict)")

    # ------------------------------------------------------------------
    def coerce_feed(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """JSON-side input conversion: nested lists to arrays of the model's
        declared feed dtype (ids stay int32, not float64)."""
        feed = {}
        for n in self.feed_names:
            if n not in inputs:
                raise KeyError(f"missing input {n!r}; model {self.model_name} feeds "
                               f"{self.feed_names}")
            dt = np.dtype(self.feed_specs.get(n, {}).get("dtype", "float32"))
            feed[n] = np.asarray(inputs[n], dtype=dt)
        return feed

    def _pad_feed(self, feed: Dict[str, np.ndarray]):
        """(padded feed, n rows, each feed's sequence length)."""
        pol = self.policy
        for k, v in feed.items():
            if isinstance(v, LoDArray):
                raise TypeError("LoD feeds are not supported by the serving engine; pad "
                                "ragged requests client-side")
        rows = {k: v.shape[0] for k, v in feed.items() if v.ndim >= 1}
        if not rows:
            raise ValueError("empty feed")
        n = next(iter(rows.values()))
        if any(r != n for r in rows.values()):
            raise ValueError(f"serving feeds must share the batch axis; got rows {rows}")
        nb = pol.batch_bucket(n)
        padded: Dict[str, np.ndarray] = {}
        seq_lens: Dict[str, int] = {}
        for k, v in feed.items():
            if v.ndim == 0:
                padded[k] = v  # a scalar feed: nothing to bucket
                continue
            pad = [(0, 0)] * v.ndim
            pad[0] = (0, nb - n)
            if pol.seq_len_buckets and v.ndim > pol.seq_axis:
                t = v.shape[pol.seq_axis]
                tb = pol.seq_bucket(t)
                seq_lens[k] = t
                if tb != t:
                    # zero positions after the batch's edge rows, so padded
                    # rows carry real sequence content
                    sp = [(0, 0)] * v.ndim
                    sp[pol.seq_axis] = (0, tb - t)
                    padded[k] = np.pad(np.pad(v, pad, mode="edge"), sp)
                    continue
            padded[k] = np.pad(v, pad, mode="edge") if nb != n else v
        return padded, n, seq_lens

    def _slice_outputs(self, outs: List[np.ndarray], n: int, nb: int,
                       seq_lens: Dict[str, int]):
        """Fetches cut back to the request's extents: the batch axis where
        it is the padded bucket's, a padded sequence axis where the fetch
        kept its length (the position-wise contract)."""
        tmap = {self.policy.seq_bucket(t): t for t in seq_lens.values()}
        ax = self.policy.seq_axis
        result = []
        for o in outs:
            o = np.asarray(o)
            if o.ndim >= 1 and o.shape[0] == nb and nb != n:
                o = o[:n]
            if o.ndim > ax and o.shape[ax] in tmap and o.shape[ax] != tmap[o.shape[ax]]:
                sl = [slice(None)] * o.ndim
                sl[ax] = slice(0, tmap[o.shape[ax]])
                o = o[tuple(sl)]
            result.append(o)
        return result

    # ------------------------------------------------------------------
    def predict(self, feed: Dict[str, np.ndarray], bucketed: bool = True) -> List[np.ndarray]:
        """Run one request (a dict of [n, ...] arrays); returns the model's
        fetches cut to the request's extents. bucketed=False runs the exact
        shape: the oracle path the bucketed one is held to."""
        t0 = time.perf_counter()
        with self._lock, profiler.timer(f"serving/{self.model_name}/predict", always=True):
            # an armed serving.predict fault is an engine failure: it fans
            # out to the batch, feeds the breaker, and surfaces as a 500
            faults.fire("serving.predict", model=self.model_name)
            if bucketed:
                padded, n, seq_lens = self._pad_feed(feed)
                nb = next(iter(padded.values())).shape[0]
            else:
                padded, seq_lens = dict(feed), {}
                n = nb = next(iter(feed.values())).shape[0]
            key = (self.model_name, tuple((k, padded[k].shape, padded[k].dtype.name)
                                          for k in sorted(padded)))
            if key in self._seen_buckets:
                self.cache_hits += 1
                self.metrics.counter_inc("compile_cache_hits_total")
            else:
                self.cache_misses += 1
                self.metrics.counter_inc("compile_cache_misses_total")
            self._seen_buckets[key] = self._seen_buckets.get(key, 0) + 1
            self.dispatches_total += 1
            self.syncs_total += 1  # the numpy fetch fences the device
            self.metrics.counter_inc("dispatches_total")
            self.metrics.counter_inc("syncs_total")
            outs = self.exe.run(self.program, feed=padded, fetch_list=list(self.fetch_names),
                                scope=self.scope)
            outs = self._slice_outputs(outs, n, nb, seq_lens)
        self._lat.observe(time.perf_counter() - t0)
        return outs

    # -- generation (continuous batching) ------------------------------
    def generation_spec(self):
        """The model's beam_search_group GenSpec, or None."""
        return self._gen_spec

    def scheduler(self, **kwargs):
        """The engine's ContinuousScheduler, built and started on first use
        (kwargs apply to that first call only)."""
        if self._gen_spec is None:
            raise ValueError(f"model {self.model_name!r} is not a generation model "
                             "(no beam_search_group op)")
        with self._lock:
            if self._scheduler is None:
                from .scheduler import ContinuousScheduler

                self._scheduler = ContinuousScheduler(self, metrics=self.metrics, **kwargs)
            elif kwargs:
                raise ValueError("scheduler already built; kwargs only apply on the first "
                                 "scheduler() call")
            return self._scheduler.start()

    def generate(self, feed: Dict[str, Any], timeout_ms: Optional[float] = None) -> Dict[str, Any]:
        """One generation request through the continuous scheduler: {"ids":
        [n,K,T], "scores": [n,K], "lengths": [n,K]}, equal to `predict`'s
        batch-mode decode. Stream with `scheduler().submit(feed).events()`."""
        return self.scheduler().generate(feed, timeout_ms=timeout_ms)

    # -- the autotuner's surfaces (A11) ---------------------------------
    def tune_coverage(self):
        raise _not_ported("tuned-kernel coverage (tune_coverage)", "A11")

    def check_tuned_table(self):
        raise _not_ported("the tuned-table check (check_tuned_table)", "A11")

    def decode_tune_cases(self):
        raise _not_ported("decode-step tuning cases (decode_tune_cases)", "A11")

    def tune_decode_kernels(self, *args, **kwargs):
        raise _not_ported("decode-step kernel tuning (tune_decode_kernels)", "A11")

    # ------------------------------------------------------------------
    def _zero_bucket_feed(self, nb: int, tb: Optional[int]):
        """A zero feed at one (batch, sequence) bucket, or None when the
        feed shapes are not concrete past the batch axis."""
        pol = self.policy
        feed = {}
        for n in self.feed_names:
            spec = self.feed_specs.get(n) or {}
            dims = list(spec.get("shape", []))[1:]
            if tb is not None and len(dims) >= pol.seq_axis:
                dims[pol.seq_axis - 1] = tb
            if any(not isinstance(d, int) or d <= 0 for d in dims):
                return None
            feed[n] = np.zeros((nb, *dims), np.dtype(spec.get("dtype", "float32")))
        return feed

    def warmup(self, tune_decode: Optional[bool] = None) -> int:
        """Runs every bucket derivable from the feed specs once (zero feeds),
        so live traffic meets no first run; for a generation model the
        scheduler's pool too (its step captured on the card). Returns the
        buckets and pool programs touched. `tune_decode=True` needs the
        autotuner (A11)."""
        if tune_decode:
            raise _not_ported("decode-step kernel tuning (tune_decode)", "A11")
        pol = self.policy
        touched = 0
        for nb in pol.batch_buckets:
            for tb in (pol.seq_len_buckets or (None,)):
                feed = self._zero_bucket_feed(nb, tb)
                if feed is None:
                    continue
                self.predict(feed)
                touched += 1
        if self._gen_spec is not None:
            touched += self.scheduler().warmup()
        return touched

    def compiled_programs(self) -> int:
        """Distinct bucket signatures run (each one's first run is the
        card's counterpart of a compile)."""
        return len(self._seen_buckets)

    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "model": self.model_name,
                "device": str(self.device),
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "hit_rate": self.hit_rate(),
                "compiled_programs": self.compiled_programs(),
                "dispatches_total": self.dispatches_total,
                "syncs_total": self.syncs_total,
                "executor_cache": dict(self.exe.cache_stats),
                "buckets": {"batch": list(self.policy.batch_buckets),
                            "seq_len": list(self.policy.seq_len_buckets)},
                "bucket_counts": {str(k[1]): c for k, c in self._seen_buckets.items()},
                **({"quant": {
                    "mode": self.quant_meta.get("mode"),
                    "sites": self.quant_meta.get("sites"),
                    "bytes_saved": self.quant_meta.get("bytes_saved"),
                    **({"accuracy_delta": self.quant_meta["accuracy_delta"]}
                       if self.quant_meta.get("accuracy_delta") is not None else {}),
                }} if self.quant_meta else {}),
                **({"generation": self._scheduler.stats()}
                   if self._scheduler is not None else {}),
            }
