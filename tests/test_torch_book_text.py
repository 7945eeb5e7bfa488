"""The book's text programs through the port (tests/book/:
understand_sentiment, word2vec, recommender_system), the ops, layers and
loaders they use, on the CPU, against the JAX package.

- The ops against the JAX ops on seeded numpy inputs, forward and the
  gradient of a seeded cotangent: `sum`, `reshape`, `cos_sim` (a zero row
  held at its eps; there the JAX norm's gradient is NaN and torch's 0, so
  that row's gradient in the port is only held finite), every `sequence_pool` mode over a ragged batch with an
  absent sequence, `stacked_lstm` in both formulations and `simple_rnn`.
  f32 within 1e-5 (rtol and atol: the same f32 arithmetic in another
  order; the LSTMs over 7 steps). `max` and `min` split a segment's
  gradient evenly among the elements tied at its extremum, as
  jax.ops.segment_max does: the inputs hold exact ties, and the test holds
  their shares to the JAX ones exactly.
- Each program built by both front ends to equal program dicts
  (stacked_lstm_net in both of its builds).
- Three steps of each program against the JAX package, from the JAX
  startup's state and the same feeds, in the form of
  tests/test_torch_book.py::test_three_steps_equal_jax: costs within 1e-5
  relative, parameters within 1e-5 of their largest or 1% of the Adam
  learning rate a step. The port's LSTMs run on its kernel route
  (lstm_kernels.lstm_fused, whose plain versions run on the CPU); the JAX
  side's run on its plain scan (at H=32 its Pallas kernel does not take
  them, and `use_fused_rnn` is off for the stacked op's run). The
  recommender's is_sparse tables take SelectedRows gradients and lazy Adam
  in both packages.
- Each program trained through the port by its reference test's recipe to
  its threshold, on the loaders' synthetic data, as the reference tests
  run (the fixtures hold 4 reviews, 2 sentences and 3 ratings: too few for
  one batch of any recipe).
- The three loaders against the JAX loaders, on tests/fixtures/data and on
  synthetic data.
- `Trainer(scan_window=4)` on the ragged sentiment program, on the
  per-step loop's bits.

The training runs set torch to one thread, as tests/test_torch_book.py does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import FLAGS as JFLAGS
from paddle_tpu import models as jmodels
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu.data import batch as jbatch
from paddle_tpu.data.datasets import imdb as jimdb
from paddle_tpu.data.datasets import imikolov as jimikolov
from paddle_tpu.data.datasets import movielens as jmovielens
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.data import batch, shuffle
from paddle_tpu_torch.data.datasets import imdb, imikolov, movielens
from paddle_tpu_torch.data.feeder import DataFeeder

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "data")
OP_TOL = 1e-5
RTOL = 1e-5
ADAM_LR_SHARE = 1e-2
N_GRAM = 5  # tests/book/test_word2vec.py
EMB = 16  # tests/book/test_recommender_system.py


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def synthetic_data(monkeypatch, tmp_path):
    """A data home with no files: the loaders make their synthetic data."""
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / "empty"))


# ------------------------------------------------------------------ ops


def _lod_pair(seqs, capacity, max_seqs):
    return (JLoD.from_sequences(seqs, capacity=capacity, max_seqs=max_seqs),
            ptt.LoDArray.from_sequences(seqs, capacity=capacity, max_seqs=max_seqs))


def _run_pair(op, inputs, attrs, out_slots, flags=()):
    """One op on both packages, forward and the VJP of a seeded cotangent
    over every float input. `inputs`: {slot: [numpy array or (lod seqs,
    capacity, max_seqs)]}. Returns [(jax value, torch value)] for each
    output, then for each float input's gradient."""
    rng = np.random.RandomState(17)
    jvals, tvals, lods, float_keys = {}, {}, {}, []
    for slot, vals in inputs.items():
        for i, v in enumerate(vals):
            key = f"{slot}_{i}"
            if isinstance(v, tuple):
                jl, tl = _lod_pair(*v)
                lods[key] = (jl, tl)
                jvals[key], tvals[key] = np.asarray(jl.data), tl.data.numpy()
            else:
                jvals[key], tvals[key] = v, v
            if np.issubdtype(np.asarray(jvals[key]).dtype, np.floating):
                float_keys.append(key)
    names = {slot: [f"{slot}_{i}" for i in range(len(v))] for slot, v in inputs.items()}
    outs = {s: [f"out_{s}"] for s in out_slots}

    def wrap(key, data, lodmod):
        if key not in lods:
            return data
        return lods[key][0 if lodmod == "j" else 1].with_data(data)

    def jrun(*fvals):
        env = {"@AMP@": None}
        for k, v in jvals.items():
            env[k] = wrap(k, jnp.asarray(v), "j")
        for k, v in zip(float_keys, fvals):
            env[k] = wrap(k, v, "j")
        jreg.get_kernel(op)(jreg.OpContext(JOp(op, names, outs, dict(attrs)), env))
        return tuple(_plain(env[f"out_{s}"]) for s in out_slots)

    with _flags(flags):
        jout, vjp = jax.vjp(jax.jit(jrun), *[jnp.asarray(jvals[k]) for k in float_keys])
        cots = tuple(jnp.asarray(rng.randn(*o.shape).astype(np.float32)) for o in jout)
        jgrads = vjp(cots)
        env = {"@AMP@": None}
        leaves = {}
        for k, v in tvals.items():
            t = torch.as_tensor(np.array(v))
            if k in float_keys:
                t.requires_grad_(True)
                leaves[k] = t
            env[k] = wrap(k, t, "t")
        treg.get_kernel(op)(treg.OpContext(TOp(op, names, outs, dict(attrs)), env))
        tout = [_plain(env[f"out_{s}"]) for s in out_slots]
        tgrads = torch.autograd.grad(tout, [leaves[k] for k in float_keys],
                                     [torch.as_tensor(np.array(c)) for c in cots],
                                     allow_unused=True)
    pairs = [(np.asarray(j), t.detach().numpy()) for j, t in zip(jout, tout)]
    pairs += [(np.asarray(j), np.zeros_like(np.asarray(j)) if t is None else t.numpy())
              for j, t in zip(jgrads, tgrads)]
    return pairs


def _plain(v):
    return v.data if isinstance(v, (JLoD, ptt.LoDArray)) else v


class _flags:
    """Sets (name, value) on both packages' FLAGS for a block."""

    def __init__(self, items):
        self.items = list(items)

    def __enter__(self):
        self.saved = [(n, getattr(JFLAGS, n), getattr(ptt.FLAGS, n)) for n, _ in self.items]
        for n, v in self.items:
            setattr(JFLAGS, n, v)
            setattr(ptt.FLAGS, n, v)

    def __exit__(self, *exc):
        for n, j, t in self.saved:
            setattr(JFLAGS, n, j)
            setattr(ptt.FLAGS, n, t)


def _ragged(rng, lens, width, ties=False):
    seqs = [rng.randn(n, width).astype(np.float32) for n in lens]
    if ties:  # exact ties at each sequence's extremum, in some columns
        for s in seqs:
            if len(s) > 2:
                s[1, ::2] = s[0, ::2] = 9.0
                s[2, 1::3] = s[0, 1::3] = -9.0
    return seqs


POOL_MODES = ["average", "sum", "sqrt", "max", "min", "last", "first"]


@pytest.mark.parametrize("mode", POOL_MODES)
def test_sequence_pool_matches_jax(mode):
    """A ragged batch of 4 sequences in 5 slots (one absent), with ties."""
    rng = np.random.RandomState(3)
    seqs = _ragged(rng, [4, 1, 6, 3], 6, ties=True)
    for j, t in _run_pair("sequence_pool", {"X": [(seqs, 20, 5)]}, {"pooltype": mode},
                          ["Out"]):
        np.testing.assert_allclose(t, j, rtol=OP_TOL, atol=OP_TOL)
    if mode in ("max", "min"):  # the ties' shares exactly
        (_, _), (jg, tg) = _run_pair("sequence_pool", {"X": [(seqs, 20, 5)]},
                                     {"pooltype": mode}, ["Out"])
        np.testing.assert_array_equal(tg, jg)


def _op_cases():
    rng = np.random.RandomState(5)
    x = rng.randn(6, 8).astype(np.float32)
    y = rng.randn(6, 8).astype(np.float32)
    y[2] = 0.0  # a zero row: the norms' product held at eps
    seqs = _ragged(rng, [3, 5, 2], 8)
    return [
        ("sum", "sum", {"X": [x, y, 2 * x]}, {}),
        ("sum-lod", "sum", {"X": [(seqs, 16, 4), (seqs, 16, 4)]}, {}),
        ("reshape", "reshape", {"X": [rng.randn(6, 1, 8).astype(np.float32)]},
         {"shape": [-1, 8]}),
        ("reshape-lod", "reshape", {"X": [(seqs, 16, 4)]}, {"shape": [4, 32]}),
        ("cos_sim", "cos_sim", {"X": [x], "Y": [y]}, {"scale": 5.0}),
        ("cos_sim-1", "cos_sim", {"X": [x], "Y": [2 * x + y]}, {}),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_op_matches_jax(case):
    name, op, inputs, attrs = case
    pairs = _run_pair(op, inputs, attrs, ["Out"])
    if name == "cos_sim":
        # y's zero row: JAX's norm has a NaN gradient at 0; torch's is 0,
        # which leaves the numerator's finite cotangent·x·scale/eps
        j, t = pairs[2]
        assert np.isnan(j[2]).all() and np.isfinite(t[2]).all()
        pairs[2] = (np.delete(j, 2, 0), np.delete(t, 2, 0))
    for j, t in pairs:
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=OP_TOL, atol=OP_TOL)


def _stacked_inputs(rng, n=3, H=8, bias=True):
    lens = [7, 3, 5, 1]
    seqs = [(0.5 * rng.randn(k, 4 * H)).astype(np.float32) for k in lens]
    w = lambda *s: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)  # noqa: E731
    ins = {"Input": [(seqs, 24, 5)], "Weights": [w(H, 4 * H) for _ in range(n)],
           "WAs": [w(4 * H, 4 * H) for _ in range(n - 1)],
           "WBs": [w(H, 4 * H) for _ in range(n - 1)]}
    if bias:
        ins["Biases"] = [(0.1 * rng.randn(4 * H)).astype(np.float32) for _ in range(n)]
        ins["FcBiases"] = [(0.1 * rng.randn(4 * H)).astype(np.float32) for _ in range(n - 1)]
    return ins


@pytest.mark.parametrize("single_scan", [False, True], ids=["layer_by_layer", "single_scan"])
@pytest.mark.parametrize("fused", [True, False], ids=["kernel_route", "scan_route"])
def test_stacked_lstm_matches_jax(single_scan, fused):
    """Three layers (and two, without biases) over a ragged batch with an
    absent sequence: FcOut, Hidden and the gradients of every input. On
    the kernel route the port runs lstm_kernels.lstm_fused (its plain
    versions here), the JAX op its scan (H=8)."""
    rng = np.random.RandomState(8)
    for n, bias in ((3, True), (2, False)):
        pairs = _run_pair("stacked_lstm", _stacked_inputs(rng, n=n, bias=bias),
                          {"max_len": 7}, ["FcOut", "Hidden"],
                          flags=[("stacked_lstm_single_scan", single_scan),
                                 ("use_fused_rnn", fused)])
        for j, t in pairs:
            np.testing.assert_allclose(t, j, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_simple_rnn_matches_jax(act):
    rng = np.random.RandomState(9)
    seqs = _ragged(rng, [5, 2, 6], 6)
    w = (rng.randn(6, 6) / np.sqrt(6)).astype(np.float32)
    b = (0.1 * rng.randn(6)).astype(np.float32)
    for j, t in _run_pair("simple_rnn", {"Input": [(seqs, 16, 4)], "Weight": [w],
                                         "Bias": [b]},
                          {"activation": act, "max_len": 6}, ["Hidden"]):
        np.testing.assert_allclose(t, j, rtol=OP_TOL, atol=OP_TOL)


def test_layers_no_longer_raise():
    """fc over several inputs, every sequence_pool mode, reshape, cos_sim,
    stacked_lstm and simple_rnn build, and their programs equal the JAX
    front end's."""

    def build(m):
        x = m.layers.data("x", shape=[12], lod_level=1)
        d = m.layers.data("d", shape=[4])
        f = m.layers.fc(x, size=16)
        h = m.layers.fc([f, x], size=16, param_attr=["a", "b"])
        pools = [m.layers.sequence_pool(h, mode) for mode in POOL_MODES]
        fc_s, h_s = m.layers.stacked_lstm(f, size=16, stacked_num=3, max_len=8)
        r = m.layers.simple_rnn(m.layers.fc(x, size=6), size=6)
        sim = m.layers.cos_sim(m.layers.fc(d, size=4), d, scale=2.0)
        flat = m.layers.reshape(d, (-1, 2))
        return pools + [fc_s, h_s, r, sim, flat]

    jp, tp = _program(pt, build), _program(ptt, build)
    assert tp.to_dict() == jp.to_dict()


def _program(m, fn):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    with m.program_guard(prog, startup):
        fn(m)
    return prog


# ------------------------------------------------------------ the programs


def _sentiment_book(m):
    """tests/book/test_understand_sentiment.py's program."""
    ids = m.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                        append_batch_size=False)
    label = m.layers.data("label", shape=[1], dtype=np.int32)
    emb = m.layers.embedding(ids, size=[5147, 32])
    fc1 = m.layers.fc(emb, size=32 * 4)
    lstm1 = m.layers.dynamic_lstm(fc1, size=32 * 4, max_len=128)
    inputs = [fc1, lstm1]
    for _ in range(2, 3):
        fc = m.layers.fc(inputs, size=32 * 4)
        lstm = m.layers.dynamic_lstm(fc, size=32 * 4, is_reverse=False, max_len=128)
        inputs = [fc, lstm]
    fc_last = m.layers.sequence_pool(inputs[0], "max")
    lstm_last = m.layers.sequence_pool(inputs[1], "max")
    logits = m.layers.fc([fc_last, lstm_last], size=2)
    cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, label))
    acc = m.layers.accuracy(logits, label)
    m.optimizer.Adam(learning_rate=0.002).minimize(cost)
    return cost, acc, [ids, label]


def _sentiment_net(stacked_op):
    """models.stacked_lstm_net (3 layers, hid 32, max_len 128) in one of
    its two builds."""

    def model(m):
        ids = m.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                            append_batch_size=False)
        label = m.layers.data("label", shape=[1], dtype=np.int32)
        models = ptt.models if m is ptt else jmodels
        logits = models.stacked_lstm_net(ids, vocab_size=5147, emb_dim=32, hid_dim=32,
                                         stacked_num=3, max_len=128,
                                         use_stacked_op=stacked_op)
        cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, label))
        acc = m.layers.accuracy(logits, label)
        m.optimizer.Adam(learning_rate=0.002).minimize(cost)
        return cost, acc, [ids, label]

    return model


def _word2vec(m, dict_size=None):
    dict_size = dict_size or len((imikolov if m is ptt else jimikolov).build_dict())
    words = [m.layers.data(f"w{i}", shape=[1], dtype=np.int32) for i in range(N_GRAM - 1)]
    nxt = m.layers.data("next", shape=[1], dtype=np.int32)
    models = ptt.models if m is ptt else jmodels
    logits = models.word2vec_net(words, dict_size, emb_dim=32)
    cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, nxt))
    m.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return cost, None, None


def _recommender(m):
    ml = movielens if m is ptt else jmovielens
    d = lambda n: m.layers.data(n, shape=[1], dtype=np.int32)  # noqa: E731
    uid, gender, age, job = d("uid"), d("gender"), d("age"), d("job")
    feats = [m.layers.embedding(uid, size=[ml.max_user_id() + 1, EMB], is_sparse=True),
             m.layers.embedding(gender, size=[2, EMB // 2]),
             m.layers.embedding(age, size=[len(ml.age_table), EMB // 2]),
             m.layers.embedding(job, size=[ml.max_job_id() + 1, EMB // 2])]
    flat = [m.layers.reshape(f, (-1, f.shape[-1])) for f in feats]
    usr = m.layers.fc(m.layers.concat(flat, axis=1), size=32, act="tanh")
    mid = d("mid")
    seq = lambda n: m.layers.data(n, shape=[-1], dtype=np.int32, lod_level=1,  # noqa: E731
                                  append_batch_size=False)
    cats, title = seq("cats"), seq("title")
    mid_flat = m.layers.reshape(
        m.layers.embedding(mid, size=[ml.max_movie_id() + 1, EMB], is_sparse=True), (-1, EMB))
    cat_pool = m.layers.sequence_pool(
        m.layers.embedding(cats, size=[len(ml.movie_categories()), EMB // 2]), "sum")
    title_pool = m.layers.sequence_pool(
        m.layers.embedding(title, size=[len(ml.get_movie_title_dict()), EMB], is_sparse=True),
        "average")
    mov = m.layers.fc(m.layers.concat([mid_flat, cat_pool, title_pool], axis=1), size=32,
                      act="tanh")
    score = m.layers.data("score", shape=[1])
    sim = m.layers.cos_sim(usr, mov, scale=5.0)
    cost = m.layers.mean(m.layers.square_error_cost(sim, score))
    m.optimizer.Adam(learning_rate=5e-3).minimize(cost)
    return cost, None, None


def _build(m, model, seed=11):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = seed
    with m.program_guard(prog, startup):
        cost, acc, feeds = model(m)
    return prog, startup, cost, acc, feeds


def _port_exe(prog, startup):
    exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _sentiment_feeds(feeds, steps):
    feeder = DataFeeder(feeds, bucket=2048, max_seqs=16)
    reader = batch(shuffle(imdb.train(), 1000, seed=0), 16, drop_last=True)
    out = []
    while len(out) < steps:
        for data in reader():
            out.append(feeder.feed(data))
            if len(out) == steps:
                break
    return out


def _word2vec_feeds():
    for data in batch(imikolov.train(imikolov.build_dict(), N_GRAM), 64, drop_last=True)():
        arr = np.array(data, np.int32)
        feed = {f"w{i}": arr[:, i:i + 1] for i in range(N_GRAM - 1)}
        feed["next"] = arr[:, N_GRAM - 1:]
        yield feed


def _recommender_feed(data):
    n = len(data)
    col = lambda i: np.array([[d[i]] for d in data], np.int32)  # noqa: E731
    lod = lambda i: ptt.LoDArray.from_sequences(  # noqa: E731
        [np.array(d[i], np.int32) for d in data], bucket=256, max_seqs=n)
    return {"uid": col(0), "gender": col(1), "age": col(2), "job": col(3), "mid": col(4),
            "cats": lod(5), "title": lod(6),
            "score": np.array([[d[7]] for d in data], np.float32)}


def _recommender_reader():
    return batch(shuffle(movielens.train(), 512, seed=0), 32, drop_last=True)


# ------------------------------------------- through the port, to threshold


def test_understand_sentiment(one_thread, synthetic_data):
    """The reference recipe: Adam(0.002), B=16, 50 steps; the accuracy of
    the last 10 above 0.8."""
    prog, startup, cost, acc, feeds = _build(ptt, _sentiment_book)
    exe, scope = _port_exe(prog, startup)
    accs = [float(exe.run(prog, feed, [acc, cost], scope=scope)[0])
            for feed in _sentiment_feeds(feeds, 50)]
    assert np.mean(accs[-10:]) > 0.8, f"final acc {np.mean(accs[-10:])}"


def test_word2vec(one_thread, synthetic_data):
    """The reference recipe: Adam(1e-2), B=64, 4 passes; the last cost
    below 0.8 of the first and below 0.9·log(dict size)."""
    prog, startup, cost, _, _ = _build(ptt, _word2vec)
    exe, scope = _port_exe(prog, startup)
    first = last = None
    for _ in range(4):
        for feed in _word2vec_feeds():
            (last,) = exe.run(prog, feed, [cost], scope=scope)
            first = last if first is None else first
    dict_size = len(imikolov.build_dict())
    assert float(last) < float(first) * 0.8, (first, last)
    assert float(last) < np.log(dict_size) * 0.9, (last, np.log(dict_size))


def test_recommender_system(one_thread, synthetic_data):
    """The reference recipe: Adam(5e-3) with lazy rows on the is_sparse
    tables, B=32, 3 passes; the mean cost of the last fifth below 0.6 of
    the first fifth's."""
    prog, startup, cost, _, _ = _build(ptt, _recommender)
    exe, scope = _port_exe(prog, startup)
    losses = [float(exe.run(prog, _recommender_feed(data), [cost], scope=scope)[0])
              for _ in range(3) for data in _recommender_reader()()]
    k = max(1, len(losses) // 5)
    assert np.mean(losses[-k:]) < np.mean(losses[:k]) * 0.6, (
        np.mean(losses[:k]), np.mean(losses[-k:]))


def test_sentiment_window_equals_per_step(one_thread, synthetic_data):
    """12 ragged batches of the sentiment program through the Trainer:
    windows of 4 against the per-step loop, the same bits."""
    prog0, _, _, _, feeds0 = _build(ptt, _sentiment_book)
    data = _sentiment_feeds(feeds0, 12)
    runs = {}
    for mode, kw in (("step", dict(log_interval=1)), ("window", dict(scan_window=4))):
        prog, startup, cost, _, _ = _build(ptt, _sentiment_book)
        t = ptt.Trainer(cost, main_program=prog, startup_program=startup, place="cpu",
                        scope=ptt.Scope())
        m = t.train(lambda: iter(data), 1, **kw)
        runs[mode] = (m, {p.name: t.scope.get(p.name).clone() for p in prog.parameters()},
                      t.host_dispatch_count)
    (ms, ps, ds), (mw, pw, dw) = runs["step"], runs["window"]
    assert ms == mw
    for n, v in ps.items():
        assert torch.equal(pw[n], v), n
    assert (ds, dw) == (12, 3)


# ------------------------------------------- against the JAX package


def _to_jax(feed):
    return {k: JLoD.from_sequences(
        [v.data.numpy()[v.offsets.numpy()[i]:v.offsets.numpy()[i + 1]]
         for i in range(int(v.num_seqs))], capacity=v.capacity, max_seqs=v.max_seqs)
        if isinstance(v, ptt.LoDArray) else v for k, v in feed.items()}


def _three_feeds(which):
    if which.startswith("sentiment"):
        return _sentiment_feeds(_build(ptt, _sentiment_book)[4], 3)
    if which == "word2vec":
        feeds = _word2vec_feeds()
        return [next(feeds) for _ in range(3)]
    data = _recommender_reader()()
    return [_recommender_feed(next(data)) for _ in range(3)]


MODELS = {"sentiment_book": (_sentiment_book, 0.002),
          "sentiment_stacked_op": (_sentiment_net(True), 0.002),
          "word2vec": (_word2vec, 1e-2), "recommender": (_recommender, 5e-3)}


@pytest.mark.parametrize("which", list(MODELS))
def test_three_steps_equal_jax(which, one_thread, synthetic_data, monkeypatch):
    model, lr = MODELS[which]
    monkeypatch.setattr(JFLAGS, "use_fused_rnn", False)
    jprog, jstartup, jcost, jacc, _ = _build(pt, model)
    tprog, tstartup, tcost, tacc, _ = _build(ptt, model)
    assert tprog.to_dict() == jprog.to_dict()
    jexe = pt.Executor()
    jexe.run(jstartup)
    js = pt.global_scope()
    state = {v.name: np.array(np.asarray(js.get(v.name)))
             for v in jprog.persistables() if js.has(v.name)}
    texe, tscope = _port_exe(tprog, tstartup)
    tio.params_from_numpy(tscope, state, "cpu")
    fetch = [jcost] + ([jacc] if jacc is not None else [])
    for feed in _three_feeds(which):
        jout = jexe.run(jprog, feed=_to_jax(feed), fetch_list=fetch)
        tout = texe.run(tprog, feed, [v.name for v in fetch], scope=tscope)
        for j, t in zip(jout, tout):
            np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=RTOL * abs(float(j)))
    for p in tprog.parameters():
        want = np.asarray(js.get(p.name))
        got = tscope.get(p.name).numpy()
        bound = max(RTOL * float(np.abs(want).max()), ADAM_LR_SHARE * 3 * lr)
        assert np.abs(got - want).max() <= bound, (p.name, float(np.abs(got - want).max()))


@pytest.mark.parametrize("stacked_op", [False, True])
def test_sentiment_net_builds_the_jax_program(stacked_op):
    model = _sentiment_net(stacked_op)
    assert _build(ptt, model)[0].to_dict() == _build(pt, model)[0].to_dict()


def test_stacked_op_equals_per_layer_build(one_thread, synthetic_data):
    """stacked_lstm_net's two builds, the stacked op's parameters bound to
    the per-layer build's by role, three Adam steps: the same costs within
    2e-5 (tests/test_stacked_lstm.py's bound for the JAX op)."""
    feeds = _three_feeds("sentiment_net")
    costs, state = {}, {}
    for stacked in (False, True):
        prog, startup, cost, _, _ = _build(ptt, _sentiment_net(stacked))
        exe, scope = _port_exe(prog, startup)
        for name, role in zip(_stack_roles(prog), state.get("roles", ())):
            scope.set(name, state[role].clone())
        if not stacked:
            state = {p.name: scope.get(p.name).clone() for p in prog.parameters()}
            state["roles"] = _stack_roles(prog)
        costs[stacked] = [float(exe.run(prog, f, [cost], scope=scope)[0]) for f in feeds]
    np.testing.assert_allclose(costs[True], costs[False], rtol=2e-5, atol=2e-5)


def _stack_roles(prog):
    """The parameters of a stacked_lstm_net build (3 layers) in one order of
    roles: the embedding, fc1's W and b, then each layer's LSTM W and b
    and, after the first, its inter-layer fc's W_fc, W_lstm and b; the
    output fc's two Ws and b."""
    ps = [p.name for p in prog.parameters()]
    if not any(".wa0" in p for p in ps):  # per-layer: creation order is role order
        emb, w1, b1, lw0, lb0, *rest = ps
        layers, out = rest[:10], rest[10:]
        stack = [lw0, lb0]
        for i in range(2):
            wa, wb, fb, lw, lb = layers[5 * i:5 * i + 5]
            stack += [wa, wb, fb, lw, lb]
        return [emb, w1, b1] + stack + out
    get = lambda s: next(p for p in ps if p.endswith(s))  # noqa: E731
    stack = [get(".w0"), get(".b0")]
    for i in range(2):
        stack += [get(f".wa{i}"), get(f".wb{i}"), get(f".fb{i}"), get(f".w{i + 1}"),
                  get(f".b{i + 1}")]
    rest = [p for p in ps if p not in stack]
    return rest[:3] + stack + rest[3:]


# ------------------------------------------------------------ the loaders


def test_loaders_read_the_fixtures(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", FIXTURES)
    # the JAX loaders cache what they read whatever the data home; these
    # reads must not outlive the test
    monkeypatch.setattr(jimdb, "_word_dict_cache", None)
    monkeypatch.setattr(jmovielens, "_REAL_META", None)
    assert imdb.word_dict() == jimdb.word_dict()
    assert imdb.word_dict(min_freq=0) == jimdb.word_dict(min_freq=0)
    assert len(imdb.word_dict(min_freq=0)) > 10
    wd = imikolov.build_dict(min_word_freq=1)
    assert wd == jimikolov.build_dict(min_word_freq=1) and len(wd) > 3
    pairs = [(imdb.train(), jimdb.train()), (imdb.test(), jimdb.test()),
             (imikolov.train(wd, N_GRAM), jimikolov.train(wd, N_GRAM)),
             (imikolov.test(wd, 3, imikolov.DataType.SEQ),
              jimikolov.test(wd, 3, jimikolov.DataType.SEQ)),
             (movielens.train(), jmovielens.train()), (movielens.test(), jmovielens.test())]
    for got, want in pairs:
        g, w = list(got()), list(want())
        assert g == w
    assert len(list(imdb.train()())) == 4 and len(list(movielens.train()())) > 0
    for fn in ("max_user_id", "max_movie_id", "max_job_id", "movie_categories",
               "get_movie_title_dict", "user_info", "movie_info"):
        assert getattr(movielens, fn)() == getattr(jmovielens, fn)(), fn


def test_loaders_synthetic_equal_jax(synthetic_data, monkeypatch):
    monkeypatch.setattr(jimdb, "_word_dict_cache", None)
    assert imdb.word_dict() == jimdb.word_dict()
    wd = imikolov.build_dict()
    assert wd == jimikolov.build_dict()
    for got, want, n in ((imdb.train(), jimdb.train(), 2000), (imdb.test(), jimdb.test(), 400),
                         (movielens.train(), jmovielens.train(), 6000),
                         (movielens.test(), jmovielens.test(), 600)):
        g, w = list(got()), list(want())
        assert len(g) == len(w) == n and g == w
    g = list(imikolov.train(wd, N_GRAM)())
    assert g == list(jimikolov.train(wd, N_GRAM)()) and len(g) > 40000
    assert list(jbatch(jimikolov.test(wd, N_GRAM), 7)()) == list(
        batch(imikolov.test(wd, N_GRAM), 7)())
    for fn in ("max_user_id", "max_movie_id", "max_job_id", "movie_categories",
               "get_movie_title_dict", "user_info", "movie_info"):
        assert getattr(movielens, fn)() == getattr(jmovielens, fn)(), fn
