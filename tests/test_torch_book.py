"""The book's first programs through the port (tests/book/: fit_a_line,
recognize_digits, machine_translation), the `accuracy`, `top_k` and
`softmax` ops they use, and the dataset loaders they read, on the CPU.

- Each program through the port alone, built and trained by the reference
  test's recipe (optimizer, batch size, steps, data) to its own threshold.
- fit_a_line also through `Trainer(scan_window=4)`, on the per-step loop's
  bits.
- Three steps of each program against the JAX package, from one numpy
  state (the JAX startup's) and the same feeds, each program built by
  both front ends with equal dicts: costs within 1e-5 relative and
  parameters within 1e-5 of their largest (f32: the same arithmetic in
  another order), or, under Adam, within 1% of the learning rate a step:
  Adam's first steps divide each gradient by its own magnitude, so where
  a gradient is near 0 two summation orders move its parameter apart by a
  share of the learning rate (0.25% measured on the MLP). machine_translation
  runs its recurrences on the plain scan routes in both packages
  (`use_fused_rnn`, `use_fused_attention` off): the kernels' plain versions
  are held to the JAX package's kernels in tests/test_torch_seq2seq.py.
- The ops against the JAX ops on seeded inputs: exact for `top_k` and
  `accuracy`'s counts, its share within one f32 ulp (XLA may divide by N
  as a product with 1/N rounded), 1e-6 for `softmax` (f32).
- The loaders read tests/fixtures/data where PADDLE_TPU_DATA_HOME points
  there and make the JAX loaders' synthetic data (the same numbers)
  otherwise; `common.download` raises and fetches nothing.

The training runs set torch to one thread: the steps are small, and
threads only add their overhead.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import FLAGS as JFLAGS
from paddle_tpu import models as jmodels
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu.data.datasets import mnist as jmnist
from paddle_tpu.data.datasets import uci_housing as juci
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.data import batch, shuffle
from paddle_tpu_torch.data.datasets import common, mnist, uci_housing

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "data")
RTOL = 1e-5
ADAM_LR_SHARE = 1e-2
BOS, EOS, VOCAB, CAP, NSEQ = 0, 1, 14, 128, 16  # tests/book/test_machine_translation.py


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


# ------------------------------------------------------------ the programs


def _fit_a_line(m):
    x = m.layers.data("x", shape=[13])
    y = m.layers.data("y", shape=[1])
    cost = m.layers.mean(m.layers.square_error_cost(m.layers.fc(x, size=1), y))
    m.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return cost, None


def _digits_mlp(m):
    img = m.layers.data("img", shape=[784])
    label = m.layers.data("label", shape=[1], dtype=np.int64)
    h1 = m.layers.fc(img, size=128, act="relu")
    h2 = m.layers.fc(h1, size=64, act="relu")
    logits = m.layers.fc(h2, size=10)
    cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, label))
    acc = m.layers.accuracy(logits, label)
    m.optimizer.Adam(learning_rate=0.003).minimize(cost)
    return cost, acc


def _digits_conv(m):
    img = m.layers.data("img", shape=[1, 28, 28])
    label = m.layers.data("label", shape=[1], dtype=np.int64)
    c1 = m.layers.conv2d(img, num_filters=8, filter_size=5, act="relu")
    p1 = m.layers.pool2d(c1, pool_size=2, pool_stride=2)
    c2 = m.layers.conv2d(p1, num_filters=16, filter_size=5, act="relu")
    p2 = m.layers.pool2d(c2, pool_size=2, pool_stride=2)
    logits = m.layers.fc(p2, size=10)
    cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, label))
    acc = m.layers.accuracy(logits, label)
    m.optimizer.Adam(learning_rate=0.003).minimize(cost)
    return cost, acc


def _translation(m):
    data = lambda n: m.layers.data(n, shape=[-1], dtype=np.int32, lod_level=1,  # noqa: E731
                                   append_batch_size=False)
    src, trg_in, label = data("src"), data("trg_in"), data("label")
    models = ptt.models if m is ptt else jmodels
    logits = models.seq2seq_attention(src, trg_in, src_vocab=VOCAB, trg_vocab=VOCAB,
                                        emb_dim=32, enc_hidden=32, dec_hidden=32,
                                        src_max_len=8, trg_max_len=8)
    tok_loss = m.layers.softmax_with_cross_entropy(logits, label)
    cost = m.layers.mean(m.layers.sequence_pool(tok_loss, "sum"))
    m.optimizer.Adam(learning_rate=0.005).minimize(cost)
    return cost, None


def _build(m, model, seed=11):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = seed
    with m.program_guard(prog, startup):
        cost, acc = model(m)
    return prog, startup, cost, acc


def _port_exe(prog, startup):
    exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _digits_feeds(reader, bs, steps, shape):
    out = []
    while len(out) < steps:
        for data in reader():
            out.append({"img": np.stack([d[0] for d in data]).reshape((bs,) + shape),
                        "label": np.array([[d[1]] for d in data], dtype=np.int64)})
            if len(out) == steps:
                break
    return out


def _mt_batch(rng, lod, n=NSEQ):
    srcs, trg_ins, labels = [], [], []
    for _ in range(n):
        s = rng.randint(2, VOCAB, (rng.randint(3, 7),)).astype(np.int32)
        t = s[::-1].copy()
        srcs.append(s)
        trg_ins.append(np.concatenate([[BOS], t]).astype(np.int32))
        labels.append(np.concatenate([t, [EOS]]).astype(np.int32))
    pack = lambda seqs: lod.from_sequences(seqs, capacity=CAP, max_seqs=n)  # noqa: E731
    return {"src": pack(srcs), "trg_in": pack(trg_ins), "label": pack(labels)}


# ------------------------------------------- through the port, to threshold


def _fit_a_line_feeds():
    reader = batch(shuffle(uci_housing.train(), 500, seed=0), 20, drop_last=True)
    return [{"x": np.stack([d[0] for d in data]), "y": np.stack([d[1] for d in data])}
            for data in reader()]


def test_fit_a_line(one_thread, synthetic_data):
    prog, startup, cost, _ = _build(ptt, _fit_a_line)
    exe, scope = _port_exe(prog, startup)
    feeds = _fit_a_line_feeds()
    for _ in range(15):
        for feed in feeds:
            (last,) = exe.run(prog, feed, [cost], scope=scope)
    assert float(last) < 1.0, f"did not converge: {last}"


def test_fit_a_line_window_equals_per_step(one_thread, synthetic_data):
    """15 passes of 20 batches through the Trainer: windows of 4 against
    the per-step loop, the same bits."""
    feeds = _fit_a_line_feeds()
    runs = {}
    for mode, kw in (("step", dict(log_interval=1)), ("window", dict(scan_window=4))):
        prog, startup, cost, _ = _build(ptt, _fit_a_line)
        t = ptt.Trainer(cost, main_program=prog, startup_program=startup, place="cpu",
                        scope=ptt.Scope())
        m = t.train(lambda: iter(feeds), 15, **kw)
        runs[mode] = (m, {p.name: t.scope.get(p.name).clone() for p in prog.parameters()},
                      t.host_dispatch_count)
    (ms, ps, ds), (mw, pw, dw) = runs["step"], runs["window"]
    assert ms == mw and ms["cost"] < 1.0
    for n, v in ps.items():
        assert torch.equal(pw[n], v), n
    assert (ds, dw) == (15 * 20, 15 * 5)


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_recognize_digits(net, one_thread, synthetic_data):
    model, batches, bs, shape, last, want = {
        "mlp": (_digits_mlp, 60, 64, (784,), 10, 0.85),
        "conv": (_digits_conv, 40, 32, (1, 28, 28), 8, 0.8)}[net]
    prog, startup, cost, acc = _build(ptt, model, seed=0)
    exe, scope = _port_exe(prog, startup)
    reader = batch(shuffle(mnist.train(), 2000, seed=0), bs, drop_last=True)
    accs = [float(exe.run(prog, feed, [acc, cost], scope=scope)[0])
            for feed in _digits_feeds(reader, bs, batches, shape)]
    assert np.mean(accs[-last:]) > want, f"final acc {np.mean(accs[-last:])}"


def test_machine_translation_train_and_beam_decode(one_thread):
    """The beam program re-binds the trained weights by name from the
    global scope (its startup is not run), as in the reference."""
    rng = np.random.RandomState(7)
    prog, startup, cost, _ = _build(ptt, _translation)
    ptt.reset_global_scope()
    exe, scope = ptt.Executor(device="cpu"), ptt.global_scope()
    exe.run(startup, scope=scope)
    costs = [float(exe.run(prog, _mt_batch(rng, ptt.LoDArray), [cost], scope=scope)[0])
             for _ in range(400)]
    final = float(np.mean(costs[-10:]))
    assert final < 0.5, f"train cost did not converge: {final:.3f}"
    infer = ptt.Program()
    with ptt.program_guard(infer, ptt.Program()):
        src_i = ptt.layers.data("src", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        outs = ptt.models.seq2seq_beam_decode(
            src_i, src_vocab=VOCAB, trg_vocab=VOCAB, emb_dim=32, enc_hidden=32, dec_hidden=32,
            beam_size=4, max_len=10, bos_id=BOS, eos_id=EOS, src_max_len=8)
    src = _mt_batch(rng, ptt.LoDArray, n=8)["src"]
    ids, scores, lens = exe.run(infer, {"src": src}, list(outs), scope=scope)
    assert ids.shape == (8, 4, 10)
    assert np.all(np.diff(scores, axis=1) <= 1e-5)  # best first
    tokens, lengths = src.data.numpy(), src.lengths.numpy()
    offs = np.concatenate([[0], np.cumsum(lengths)])
    correct = 0
    for b in range(8):
        expect = tokens[offs[b]:offs[b + 1]][::-1]
        best = ids[b, 0, :lens[b, 0]]
        if best[-1] == EOS:
            best = best[:-1]
        correct += int(len(best) == len(expect) and np.all(best == expect))
    assert correct >= 6, f"beam decode got {correct}/8 reversals right"


# ------------------------------------------- against the JAX package


def _three_feeds(which):
    if which == "fit_a_line":
        return _fit_a_line_feeds()[:3]
    if which in ("mlp", "conv"):
        bs, shape = (64, (784,)) if which == "mlp" else (32, (1, 28, 28))
        reader = batch(shuffle(mnist.train(), 2000, seed=0), bs, drop_last=True)
        return _digits_feeds(reader, bs, 3, shape)
    rng = np.random.RandomState(7)
    return [_mt_batch(rng, ptt.LoDArray) for _ in range(3)]


def _to_jax(feed):
    from paddle_tpu.core.lod import LoDArray as JLoD

    return {k: JLoD.from_sequences(
        [v.data.numpy()[v.offsets.numpy()[i]:v.offsets.numpy()[i + 1]]
         for i in range(int(v.num_seqs))], capacity=v.capacity, max_seqs=v.max_seqs)
        if isinstance(v, ptt.LoDArray) else v for k, v in feed.items()}


@pytest.mark.parametrize("which", ["fit_a_line", "mlp", "conv", "translation"])
def test_three_steps_equal_jax(which, one_thread, synthetic_data, monkeypatch):
    model = {"fit_a_line": _fit_a_line, "mlp": _digits_mlp, "conv": _digits_conv,
             "translation": _translation}[which]
    lr = {"fit_a_line": 0.0, "mlp": 0.003, "conv": 0.003, "translation": 0.005}[which]
    if which == "translation":
        for flags in (JFLAGS, ptt.FLAGS):
            monkeypatch.setattr(flags, "use_fused_rnn", False)
            monkeypatch.setattr(flags, "use_fused_attention", False)
    jprog, jstartup, jcost, jacc = _build(pt, model)
    tprog, tstartup, tcost, tacc = _build(ptt, model)
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


# ------------------------------------------------------------------ ops


def _op_cases():
    rng = np.random.RandomState(5)
    logits = rng.randn(12, 10).astype(np.float32)
    label = rng.randint(0, 10, (12, 1)).astype(np.int64)
    label[:4, 0] = np.argmax(logits[:4], axis=1)  # some rows right
    return [
        ("top_k-1", "top_k", {"X": [logits]}, {"k": 1}, ("Out", "Indices")),
        ("top_k-3", "top_k", {"X": [logits]}, {"k": 3}, ("Out", "Indices")),
        ("accuracy-1", "accuracy",
         {"Indices": [np.argsort(-logits, 1)[:, :1].astype(np.int32)], "Label": [label]}, {},
         ("Accuracy", "Correct", "Total")),
        ("accuracy-3", "accuracy",
         {"Indices": [np.argsort(-logits, 1)[:, :3].astype(np.int32)], "Label": [label]}, {},
         ("Accuracy", "Correct", "Total")),
        ("softmax", "softmax", {"X": [3 * logits]}, {}, ("Out",)),
        ("softmax-3d", "softmax", {"X": [rng.randn(2, 5, 7).astype(np.float32)]}, {}, ("Out",)),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_op_matches_jax(case):
    import jax.numpy as jnp

    _, op, inputs, attrs, outs = case
    slots = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in inputs.items()}
    jenv, tenv = {"@AMP@": None}, {"@AMP@": None}
    for k, vals in inputs.items():
        for name, v in zip(slots[k], vals):
            jenv[name], tenv[name] = jnp.asarray(v), torch.as_tensor(v)
    out_slots = {s: [f"out_{s}"] for s in outs}
    jreg.get_kernel(op)(jreg.OpContext(JOp(op, slots, out_slots, dict(attrs)), jenv))
    treg.get_kernel(op)(treg.OpContext(TOp(op, slots, out_slots, dict(attrs)), tenv))
    for s in outs:
        j, t = np.asarray(jenv[f"out_{s}"]), tenv[f"out_{s}"].numpy()
        assert t.dtype == j.dtype and t.shape == j.shape, (s, t.dtype, j.dtype)
        if op == "softmax":
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
        elif s == "Accuracy":  # XLA's mean may multiply by 1/N rounded: one ulp
            np.testing.assert_allclose(t, j, rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(t, j)


def test_layers_build_the_jax_programs():
    for model in (_digits_mlp, _digits_conv):
        assert _build(ptt, model)[0].to_dict() == _build(pt, model)[0].to_dict()

    def soft(m):
        x = m.layers.data("x", shape=[5])
        return m.layers.softmax(x), None

    assert _build(ptt, soft)[0].to_dict() == _build(pt, soft)[0].to_dict()


# ------------------------------------------------------------ the loaders


def test_loaders_read_the_fixtures(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", FIXTURES)
    for mod, jmod in ((uci_housing, juci), (mnist, jmnist)):
        for split in ("train", "test"):
            got, want = list(getattr(mod, split)()()), list(getattr(jmod, split)()())
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1], w[1])
    x, y = next(uci_housing.train()())
    assert x.shape == (13,) and y.shape == (1,) and x.dtype == np.float32


def test_loaders_synthetic_equal_jax(synthetic_data):
    for mod, jmod, n in ((uci_housing, juci, 404), (mnist, jmnist, 8000)):
        got, want = list(mod.train()()), list(jmod.train()())
        assert len(got) == len(want) == n
        for g, w in zip(got[:50], want[:50]):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1] if np.ndim(w[1]) == 0 else np.array_equal(g[1], w[1])


def test_download_fetches_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    import urllib.request

    def no_network(*a, **kw):
        raise AssertionError("the port opened a URL")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    with pytest.raises(RuntimeError, match="fetches nothing"):
        uci_housing.fetch()
    d = tmp_path / "uci_housing"
    d.mkdir()
    (d / "housing.data").write_bytes(b"0 1 2\n")
    with pytest.raises(RuntimeError, match="md5"):
        common.download(uci_housing.URL, "uci_housing", uci_housing.MD5)
    md5 = common.md5file(str(d / "housing.data"))
    assert common.download(uci_housing.URL, "uci_housing", md5) == str(d / "housing.data")
    with pytest.raises(NotImplementedError, match="A12"):
        uci_housing.convert(str(tmp_path / "out"))
