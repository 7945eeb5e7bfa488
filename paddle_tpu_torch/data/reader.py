"""Reader combinators (paddle_tpu/data/reader.py:30-226, plain Python,
the same code): a *reader* is a zero-arg callable returning an iterable
of samples; combinators wrap readers. map_readers, shuffle (seeded, so it
gives the JAX package's order), chain, compose, buffered, firstn,
xmap_readers (a parallel map on threads), batch and cache.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Callable, Iterable, List

__all__ = [
    "map_readers",
    "shuffle",
    "chain",
    "compose",
    "buffered",
    "firstn",
    "xmap_readers",
    "batch",
    "cache",
]


def map_readers(func, *readers):
    """Apply func to the sample tuples zipped from readers (decorator.py:29)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size: int, seed=None):
    """Buffered shuffle (decorator.py:60)."""

    def new_reader():
        rnd = _random.Random(seed)
        buf: List = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rnd.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rnd.shuffle(buf)
            yield from buf

    return new_reader


def chain(*readers):
    """Concatenate readers (decorator.py:89)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, check_alignment: bool = True):
    """Zip samples from several readers into combined tuples (decorator.py:128)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        iters = [iter(r) for r in rs]
        while True:
            outs = []
            stop = 0
            for it in iters:
                try:
                    outs.append(make_tuple(next(it)))
                except StopIteration:
                    stop += 1
                    outs.append(None)
            if stop:
                if check_alignment and stop != len(iters):
                    raise RuntimeError("readers not aligned in compose()")
                return
            yield sum(outs, ())

    return reader


def buffered(reader, size: int):
    """Read-ahead via a daemon thread (decorator.py:180) — the Python analogue

    of the reference's double-buffered DataProvider (DataProvider.h:375)."""

    end = object()

    def new_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                return
            yield e

    return new_reader


def firstn(reader, n: int):
    def new_reader():
        return itertools.islice(reader(), n)

    return new_reader


def xmap_readers(mapper, reader, process_num: int, buffer_size: int, order: bool = False):
    """Parallel map over samples with worker threads (decorator.py:236)."""

    end = object()

    def new_reader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        errors: List[BaseException] = []

        def feed():
            try:
                for i, d in enumerate(reader()):
                    in_q.put((i, d))
            except BaseException as e:  # propagate, don't hang the consumer
                errors.append(e)
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is end:
                        return
                    i, d = item
                    out_q.put((i, mapper(d)))
            except BaseException as e:
                errors.append(e)
            finally:
                out_q.put(end)

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                i, d = item
                pending[i] = d
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            while want in pending:
                yield pending.pop(want)
                want += 1
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
        if errors:
            raise errors[0]

    return new_reader


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists (reference: python/paddle/v2/minibatch.py)."""

    def new_reader():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return new_reader


def cache(reader):
    """Materialize once, then replay from memory."""
    data: List = []
    filled = [False]

    def new_reader():
        if not filled[0]:
            data.extend(reader())
            filled[0] = True
        return iter(data)

    return new_reader
