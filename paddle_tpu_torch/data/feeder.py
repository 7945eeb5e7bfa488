"""Host batches -> feed dicts, and their copy to the card off the step
(paddle_tpu/data/feeder.py).

`DataFeeder` (:23) turns a batch of samples into a feed dict: a dense slot
stacks to a numpy array, a `lod_level=1` slot becomes a LoDArray and a
sparse slot (`data(..., sparse_format=...)`) a SparseArray, each with
bucketed capacity and equal to the JAX package's.

`DevicePrefetcher` (:105) is the JAX prefetcher redone for CUDA. A
producer thread walks the reader, converts each batch (through the
DataFeeder, when given), copies every host tensor into pinned memory and
from there to the card with `non_blocking=True` on a side stream of its
own, and records an event on that stream. The consumer makes its current
stream wait on the event and calls `record_stream` on each tensor it
takes, so the caching allocator does not hand a block the step still reads
to the next copy. Batch N+1's copy runs beside batch N's kernels. A tensor
already on the target device passes through; on a CPU executor the thread
converts and pins nothing. Reader errors reach the consumer, and the order
is the reader's.

`DevicePrefetcher(window=K)` is the scan window's feed (:65-225): it
groups consecutive batches of one feed signature and yields `FeedWindow`s
of up to K of them, stacked on a leading window axis by `_stack_feeds` on
the same side stream after their copies (a LoDArray or a SparseArray leaf
by leaf; a SparseArray's capacity is the feeder's, fixed for the window). A
signature change or the end of the pass flushes a shorter window.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.executor import _feed_signature
from ..core.lod import LoDArray
from ..core.place import resolve_device
from ..core.sparse import SparseArray, feed_leaves, feed_like
from ..obs import trace as obs_trace

__all__ = ["DataFeeder", "DevicePrefetcher", "FeedWindow"]


class DataFeeder:
    """feed(batch) -> {name: array or LoDArray} for the program's feed
    Variables, in `feed_list` order of the samples' fields."""

    def __init__(self, feed_list: Sequence, bucket: int = 256, max_seqs: int = None):
        self.feed_list = list(feed_list)
        self.bucket = bucket
        self.max_seqs = max_seqs

    def feed(self, batch: List[Sequence]) -> Dict[str, Any]:
        """batch: list of samples, each a tuple aligned with feed_list."""
        out = {}
        for slot_idx, var in enumerate(self.feed_list):
            vals = [sample[slot_idx] for sample in batch]
            if var.sparse_format:
                # each sample a list of active indices, or of (index, value)
                # pairs (SparseBinaryScanner / SparseFloatScanner)
                out[var.name] = SparseArray.from_batch(
                    vals, dim=int(var.shape[-1]), format=var.sparse_format,
                    bucket=self.bucket, dtype=np.dtype(var.dtype))
            elif var.lod_level == 0:
                arr = np.asarray(vals, dtype=np.dtype(var.dtype))
                want = tuple(d for d in var.shape if d != -1)
                if arr.ndim == 1 and want:
                    arr = arr.reshape((len(batch),) + want)
                out[var.name] = arr
            else:
                trailing = tuple(d for d in var.shape[1:] if d != -1)
                seqs = [np.asarray(v, dtype=np.dtype(var.dtype)).reshape((-1,) + trailing)
                        for v in vals]
                out[var.name] = LoDArray.from_sequences(
                    seqs, bucket=self.bucket, max_seqs=self.max_seqs or len(batch))
        return out


class FeedWindow:
    """K feeds of one signature stacked on a leading window axis: the unit
    `Executor.run_window` takes. `k` is short of the configured window for
    the ragged tail of a pass or before a signature change."""

    __slots__ = ("feed", "k")

    def __init__(self, feed: Dict[str, Any], k: int):
        self.feed = feed
        self.k = int(k)

    def slice(self, i: int) -> Dict[str, Any]:
        """Step i's feed as a window of 1 (the leading axis kept): the
        StepGuard's cool-down runs these one at a time."""
        return {name: feed_like(v, [t[i:i + 1] for t in feed_leaves(v)])
                for name, v in self.feed.items()}


def _stack_feeds(feeds: List[Dict[str, Any]]) -> FeedWindow:
    """K feed dicts of one signature, already on their device, stacked to
    a leading window axis on the current stream: one `torch.stack` a dense
    slot, one a leaf of a LoDArray or SparseArray slot."""
    def stack(vs):
        if isinstance(vs[0], (LoDArray, SparseArray)):
            return feed_like(vs[0], [torch.stack(ts) for ts in zip(*map(feed_leaves, vs))])
        return torch.stack([torch.as_tensor(v) for v in vs])

    return FeedWindow({name: stack([f[name] for f in feeds]) for name in feeds[0]}, len(feeds))


def _is_host(v) -> bool:
    return isinstance(v, np.ndarray) or (isinstance(v, torch.Tensor) and v.device.type == "cpu")


class DevicePrefetcher:
    """Iterates the reader's batches as feed dicts of tensors on `device`
    (default: the card), `depth` batches ahead of the consumer; with
    `window=K`, FeedWindows of up to K batches, `depth` windows ahead.

        for feed in DevicePrefetcher(reader, feeder, depth=2):
            exe.run(prog, feed=feed, ...)
    """

    def __init__(self, reader, feeder: Optional[DataFeeder] = None, depth: int = 2,
                 device=None, window: int = 0):
        self.reader = reader
        self.feeder = feeder
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        # window > 0: yield FeedWindows of up to `window` batches; depth
        # then counts windows
        self.window = max(0, int(window))

    # -- producer side ---------------------------------------------------
    def _put(self, v, copied: list):
        """One tensor on the device. On the card a host value goes through
        pinned memory and a non-blocking copy on the current (side) stream;
        the copy is listed in `copied` for the consumer's record_stream."""
        if isinstance(v, (LoDArray, SparseArray)):
            return feed_like(v, [self._put(t, copied) for t in v.leaves()])
        if not _is_host(v):
            if isinstance(v, torch.Tensor) and v.device == self.device:
                return v  # already there: pass through
            if isinstance(v, torch.Tensor):
                return v.to(self.device)
            raise TypeError(f"feed value of type {type(v).__name__}: expected a numpy "
                            "array, a tensor or a LoDArray")
        t = torch.as_tensor(v)
        if self.device.type == "cpu":
            return t
        dev = t.pin_memory().to(self.device, non_blocking=True)
        copied.append(dev)
        return dev

    def _stacked(self, buf, stream):
        """(FeedWindow, event, its tensors) for the batches in `buf`,
        stacked on the side stream after their copies."""
        armed = obs_trace._armed
        if armed:
            obs_trace._begin("prefetch.window", "prefetch")
        if stream is None:
            win, event = _stack_feeds(buf), None
        else:
            with torch.cuda.stream(stream):
                win = _stack_feeds(buf)
                event = stream.record_event()
        if armed:
            obs_trace._end()
        leaves = [t for v in win.feed.values() for t in feed_leaves(v)]
        return win, event, leaves if event is not None else []

    def _produce(self, q: "queue.Queue", stop: threading.Event, end, err) -> None:
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        buf, sig = [], None
        try:
            for i, batch in enumerate(self.reader()):
                if stop.is_set():
                    return
                armed = obs_trace._armed
                if armed:
                    # the batch index the trainer's step spans carry too
                    obs_trace.set_context(batch=i)
                    obs_trace._begin("prefetch.batch", "prefetch")
                feed = self.feeder.feed(batch) if self.feeder else batch
                copied: list = []
                event = None
                if stream is None:
                    feed = {k: self._put(v, copied) for k, v in feed.items()}
                else:
                    with torch.cuda.stream(stream):
                        feed = {k: self._put(v, copied) for k, v in feed.items()}
                        if not self.window:
                            event = stream.record_event() if copied else None
                if armed:
                    obs_trace._end()
                if not self.window:
                    q.put((feed, event, copied))
                    continue
                s = _feed_signature(feed)
                if buf and s != sig:
                    # a new signature: the partial window goes first, so a
                    # window never mixes shapes
                    q.put(self._stacked(buf, stream))
                    buf = []
                sig = s
                buf.append(feed)
                if len(buf) == self.window:
                    q.put(self._stacked(buf, stream))
                    buf = []
            if buf:  # the pass's ragged tail
                q.put(self._stacked(buf, stream))
            q.put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put((err, e))

    # -- consumer side ---------------------------------------------------
    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        END, ERR = object(), object()
        t = threading.Thread(target=self._produce, args=(q, stop, END, ERR), daemon=True,
                             name="ptt-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is END:
                    return
                if item[0] is ERR:
                    raise item[1]
                feed, event, copied = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for c in copied:
                        c.record_stream(current)
                yield feed
        finally:
            stop.set()
            # drain so a blocked producer can observe stop and exit
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
