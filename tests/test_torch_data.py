"""The port's data path against the JAX package's: the reader decorators
(`paddle_tpu_torch/data/reader.py`) on the same seeded readers, the
DataFeeder on dense and `lod_level=1` samples, and the CPU
DevicePrefetcher (order, reader errors, training with a feeder), the
counterparts of tests/test_io_trainer.py:261-327. No card: the prefetcher
runs with `device="cpu"`, where it converts in its thread and pins
nothing."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.lod import LoDArray as JaxLoD
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.data import reader as jreader
from paddle_tpu_torch.data import reader as treader
from paddle_tpu_torch.data.feeder import DataFeeder, DevicePrefetcher


def _samples(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [(i, float(rng.randn())) for i in range(n)]


def _reader(data):
    def r():
        yield from data
    return r


@pytest.mark.parametrize("buf,seed", [(5, 0), (7, 3), (100, 11)])
def test_shuffle_gives_the_jax_order(buf, seed):
    data = _samples()
    want = list(jreader.shuffle(_reader(data), buf, seed=seed)())
    got = list(treader.shuffle(_reader(data), buf, seed=seed)())
    assert got == want and sorted(got) == sorted(data)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("size", [4, 5, 23])
def test_batch(size, drop_last):
    data = _samples()
    want = list(jreader.batch(_reader(data), size, drop_last=drop_last)())
    got = list(treader.batch(_reader(data), size, drop_last=drop_last)())
    assert got == want


def test_buffered_map_chain_firstn_cache():
    data = _samples()
    for name, args in (("buffered", (3,)), ("firstn", (7,))):
        want = list(getattr(jreader, name)(_reader(data), *args)())
        assert list(getattr(treader, name)(_reader(data), *args)()) == want
    sq = lambda a, b: (a[0], b[1] * 2)  # noqa: E731
    assert list(treader.map_readers(sq, _reader(data), _reader(data))()) == \
        list(jreader.map_readers(sq, _reader(data), _reader(data))())
    assert list(treader.chain(_reader(data), _reader(data[:3]))()) == \
        list(jreader.chain(_reader(data), _reader(data[:3]))())
    cached = treader.cache(_reader(data))
    assert list(cached()) == list(cached()) == data


def test_xmap_readers_ordered_matches():
    data = _samples(40)
    fn = lambda s: (s[0], s[1] ** 2)  # noqa: E731
    want = list(jreader.xmap_readers(fn, _reader(data), 4, 8, order=True)())
    got = list(treader.xmap_readers(fn, _reader(data), 4, 8, order=True)())
    assert got == want == [fn(s) for s in data]
    unordered = list(treader.xmap_readers(fn, _reader(data), 3, 4)())
    assert sorted(unordered) == sorted(want)


def test_xmap_readers_passes_errors_on():
    def bad():
        yield (0, 1.0)
        raise ValueError("broken reader")

    with pytest.raises(ValueError, match="broken reader"):
        list(treader.xmap_readers(lambda s: s, bad, 2, 2, order=True)())


def test_compose_alignment():
    a, b = _reader([1, 2, 3]), _reader([(4, 5), (6, 7), (8, 9)])
    assert list(treader.compose(a, b)()) == list(jreader.compose(a, b)()) == \
        [(1, 4, 5), (2, 6, 7), (3, 8, 9)]
    short = _reader([1, 2])
    for mod in (treader, jreader):
        with pytest.raises(RuntimeError, match="not aligned"):
            list(mod.compose(a, short)())
    assert list(treader.compose(a, short, check_alignment=False)()) == \
        list(jreader.compose(a, short, check_alignment=False)()) == [(1, 1), (2, 2)]


def _vars(m):
    m.reset_default_programs()
    main, startup = m.Program(), m.Program()
    with m.program_guard(main, startup):
        img = m.layers.data("img", shape=[3, 2])
        label = m.layers.data("label", shape=[1], dtype=np.int32)
        words = m.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                              append_batch_size=False)
        vecs = m.layers.data("vecs", shape=[-1, 4], dtype=np.float32, lod_level=1,
                             append_batch_size=False)
    return [img, label, words, vecs]


def _feed_batch(rng, n=5):
    return [(rng.randn(3, 2).astype(np.float32), [int(rng.randint(10))],
             rng.randint(0, 50, size=rng.randint(1, 7)).tolist(),
             rng.randn(rng.randint(1, 4), 4).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("bucket", [8, 256])
def test_datafeeder_equals_jax(bucket):
    batch = _feed_batch(np.random.RandomState(1))
    want = jfeeder.DataFeeder(_vars(pt), bucket=bucket).feed(batch)
    got = DataFeeder(_vars(ptt), bucket=bucket).feed(batch)
    assert sorted(got) == sorted(want)
    for k in ("img", "label"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("words", "vecs"):
        assert isinstance(want[k], JaxLoD) and isinstance(got[k], ptt.LoDArray)
        for leaf in ("data", "seq_ids", "lengths", "num_seqs"):
            g, w = getattr(got[k], leaf).numpy(), np.asarray(getattr(want[k], leaf))
            assert g.dtype == w.dtype and g.shape == w.shape, (k, leaf)
            np.testing.assert_array_equal(g, w)


def test_prefetcher_keeps_order_and_runs_ahead():
    produced = []

    def reader():
        for i in range(6):
            produced.append(i)
            yield {"x": np.full((2, 2), i, np.float32),
                   "lod": ptt.LoDArray.from_sequences([np.arange(i + 1, dtype=np.int32)])}

    got = []
    ahead = threading.Event()
    for feed in DevicePrefetcher(reader, depth=2, device="cpu"):
        assert isinstance(feed["x"], torch.Tensor) and feed["x"].device.type == "cpu"
        assert not feed["x"].is_pinned()
        got.append(int(feed["x"][0, 0]))
        assert int(feed["lod"].lengths[0]) == got[-1] + 1
        for _ in range(200):  # the producer fills the queue while we hold a batch
            if len(produced) >= min(len(got) + 2, 6):
                ahead.set()
                break
            threading.Event().wait(0.005)
    assert got == list(range(6)) and produced == list(range(6))
    assert ahead.is_set()


def test_prefetcher_passes_reader_errors_on():
    def reader():
        yield {"x": np.zeros((1,), np.float32)}
        raise RuntimeError("reader exploded")

    it = iter(DevicePrefetcher(reader, depth=1, device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="reader exploded"):
        next(it)


def test_prefetcher_passes_device_tensors_through():
    t = torch.arange(4.0)

    def reader():
        yield {"t": t}

    (feed,) = list(DevicePrefetcher(reader, device="cpu"))
    assert feed["t"] is t


def test_prefetcher_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher(lambda: iter(()))


def test_prefetcher_with_feeder_trains():
    """End to end: prefetched feeds of a DataFeeder drive training steps."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[4])
        y = ptt.layers.data("y", shape=[1])
        pred = ptt.layers.fc(x, size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope, seed=0)
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype(np.float32)
    data = []
    for _ in range(6):
        xs = rng.randn(8, 4).astype(np.float32)
        data.append([(a, a @ w) for a in xs])
    losses = []
    for _ in range(3):
        for feed in DevicePrefetcher(lambda: iter(data), DataFeeder([x, y]), depth=2,
                                     device="cpu"):
            (l,) = exe.run(main, feed, [loss], scope=scope)
            losses.append(float(l))
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
