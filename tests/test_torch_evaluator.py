"""The port's evaluators and gradient checker against the JAX package's.

- Each evaluator of paddle_tpu_torch/evaluator.py fed the same seeded
  batches as the JAX one's (the port's half of them as torch tensors, which
  it hands back to the host): eval() equal, numbers and all.
- `check_gradient` run through the port's Executor and autodiff on programs
  of the ops this slice adds (`sum` by a several-input fc, `cos_sim`,
  `sequence_pool` max and average, `reshape`, `stacked_lstm`, `simple_rnn`,
  an is_sparse table's SelectedRows gradient, which the JAX checker does
  not read: its side checks that program with a dense table), from the JAX
  startup's state, beside the JAX `check_gradient` on the same program,
  feed and elements: both pass at the JAX test's tolerances (eps 1e-2, rtol 5e-2,
  atol 1e-3, f32; eps 2e-3 for the LSTM stack, whose loss curves within
  1e-2 of a weight), over the same parameters; and a kernel with a wrong
  gradient fails the port's check.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import evaluator as jev
from paddle_tpu_torch import evaluator as tev
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import registry as treg


def _batches(name, rng):
    """Three batches of update() arguments for the evaluator `name`."""
    out = []
    for _ in range(3):
        n = 40
        if name in ("Accuracy", "PrecisionRecall"):
            out.append((rng.rand(n, 4).astype(np.float32), rng.randint(0, 4, (n, 1))))
        elif name == "Auc":
            out.append((rng.rand(n, 2).astype(np.float32), rng.randint(0, 2, n)))
        elif name == "ChunkEvaluator":
            tags = lambda: [rng.randint(0, 7, rng.randint(3, 12)) for _ in range(5)]  # noqa: E731
            out.append((tags(), tags()))
        elif name == "EditDistance":
            seqs = lambda: [rng.randint(0, 5, rng.randint(1, 9)) for _ in range(6)]  # noqa: E731
            out.append((seqs(), seqs()))
        elif name == "DetectionMAP":
            dets, boxes, labels = [], [], []
            for _ in range(4):
                k, m = rng.randint(1, 6), rng.randint(1, 4)
                xy = rng.rand(k, 2)
                d = np.concatenate([rng.randint(0, 3, (k, 1)), rng.rand(k, 1), xy,
                                    xy + 0.2 + 0.3 * rng.rand(k, 2)], 1)
                gxy = rng.rand(m, 2)
                dets.append(d)
                boxes.append(np.concatenate([gxy, gxy + 0.3], 1))
                labels.append(rng.randint(0, 3, m))
            out.append((dets, boxes, labels))
        elif name == "RankAuc":
            s = rng.rand(n)
            s[:6] = 0.5  # ties
            out.append((s, rng.rand(n).round(1), rng.rand(n) + 0.5))
        elif name == "PnPair":
            s = rng.rand(n)
            s[:6] = 0.25
            out.append((s, rng.randint(0, 3, n), rng.randint(0, 4, n)))
        else:  # ValuePrinter
            out.append((rng.randn(3, 5).astype(np.float32), np.zeros((0,))))
    return out


EVALUATORS = {"Accuracy": (), "PrecisionRecall": (4,), "Auc": (64,), "ChunkEvaluator": (3, "iob"),
              "EditDistance": (True,), "DetectionMAP": (3, 0.5, "11point"), "RankAuc": (),
              "PnPair": (), "ValuePrinter": ("v",)}


def _tensor(a):
    return torch.as_tensor(a) if isinstance(a, np.ndarray) and a.dtype != object else a


@pytest.mark.parametrize("name", list(EVALUATORS))
def test_evaluator_equals_jax(name, capsys):
    rng = np.random.RandomState(abs(hash(name)) % 1000)
    args = EVALUATORS[name]
    j, t = getattr(jev, name)(*args), getattr(tev, name)(*args)
    for i, b in enumerate(_batches(name, rng)):
        j.update(*b)
        t.update(*(b if i % 2 else tuple(_tensor(a) for a in b)))
    want, got = j.eval(), t.eval()
    assert got == want, (got, want)
    if name == "PrecisionRecall":
        for k, v in j.eval_all().items():
            np.testing.assert_array_equal(t.eval_all()[k], v)
    if name == "EditDistance":
        assert t.instance_error_rate == j.instance_error_rate
    t.reset()
    j.reset()
    if name not in ("ValuePrinter", "PnPair"):
        assert t.eval() == j.eval()


def test_evaluator_takes_bf16_tensors():
    ev = tev.Accuracy()
    ev.update(torch.tensor([[0.1, 0.9], [0.8, 0.2]], dtype=torch.bfloat16),
              torch.tensor([[1], [1]]))
    assert ev.eval() == 0.5


# ------------------------------------------------------- gradient checker


def _grad_program(m, which, sparse=True):
    """A small regression program through one of the new ops."""
    if which == "sum_cos_sim":
        a = m.layers.data("a", shape=[5])
        b = m.layers.data("b", shape=[3])
        h = m.layers.fc([a, b], size=4, act="tanh")
        pred = m.layers.cos_sim(h, m.layers.fc(b, size=4), scale=2.0)
    elif which == "pool_reshape":
        x = m.layers.data("x", shape=[4], lod_level=1)
        h = m.layers.fc(x, size=6, act="tanh")
        pooled = m.layers.fc([m.layers.sequence_pool(h, "max"),
                              m.layers.sequence_pool(h, "average")], size=4)
        pred = m.layers.fc(m.layers.reshape(pooled, (-1, 4)), size=1)
    elif which == "stacked_lstm":
        x = m.layers.data("x", shape=[4], lod_level=1)
        proj = m.layers.fc(x, size=16)
        fc_s, h_s = m.layers.stacked_lstm(proj, size=16, stacked_num=2, max_len=6)
        pred = m.layers.fc([m.layers.sequence_pool(fc_s, "max"),
                            m.layers.sequence_pool(h_s, "last")], size=1)
    elif which == "simple_rnn":
        x = m.layers.data("x", shape=[4], lod_level=1)
        r = m.layers.simple_rnn(m.layers.fc(x, size=5), size=5, max_len=6)
        pred = m.layers.fc(m.layers.sequence_pool(r, "sum"), size=1)
    else:  # an is_sparse table: SelectedRows gradient
        ids = m.layers.data("ids", shape=[1], dtype=np.int32)
        e = m.layers.embedding(ids, size=[7, 3], is_sparse=sparse)
        pred = m.layers.fc(m.layers.reshape(e, (-1, 3)), size=1, act="tanh")
    y = m.layers.data("y", shape=[1])
    loss = m.layers.mean(m.layers.square_error_cost(pred, y))
    m.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _grad_feed(which, lod):
    rng = np.random.RandomState(4)
    if which == "sum_cos_sim":
        feed = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(6, 3).astype(np.float32)}
    elif which == "sparse_table":
        feed = {"ids": np.array([[1], [4], [1], [6], [0], [4]], np.int32)}
    else:
        seqs = [rng.randn(k, 4).astype(np.float32) for k in (3, 6, 1, 4, 2, 5)]
        feed = {"x": lod.from_sequences(seqs, capacity=24, max_seqs=6)}
    feed["y"] = rng.randn(6, 1).astype(np.float32)
    return feed


CHECK = dict(eps=1e-2, rtol=5e-2, atol=1e-3)
# the LSTM stack's loss curves within 1e-2 of a weight: a smaller step
EPS = {"stacked_lstm": 2e-3}


@pytest.mark.parametrize("which", ["sum_cos_sim", "pool_reshape", "stacked_lstm",
                                   "simple_rnn", "sparse_table"])
def test_check_gradient_beside_jax(which):
    from paddle_tpu.core.lod import LoDArray as JLoD

    pt.reset()
    _grad_program(pt, which)
    jdict = pt.default_main_program().to_dict()
    # the JAX checker reads a dense gradient: its side of the sparse case
    # checks the same program with a dense table
    pt.reset()
    pt.default_startup_program().random_seed = 5
    jloss = _grad_program(pt, which, sparse=False)
    pt.Executor().run(pt.default_startup_program())
    js = pt.global_scope()
    jprog = pt.default_main_program()
    check = dict(CHECK, eps=EPS.get(which, CHECK["eps"]))
    want = pt.check_gradient(jloss, _grad_feed(which, JLoD), **check)

    ptt.reset_default_programs()
    tloss = _grad_program(ptt, which)
    assert ptt.default_main_program().to_dict() == jdict
    scope = ptt.Scope()
    tio.params_from_numpy(scope, {v.name: np.asarray(js.get(v.name))
                                  for v in jprog.persistables() if js.has(v.name)}, "cpu")
    got = ptt.check_gradient(tloss, _grad_feed(which, ptt.LoDArray), scope=scope, device="cpu",
                             **check)
    assert sorted(got) == sorted(want) and got
    for p, d in got.items():
        assert d <= CHECK["atol"] + CHECK["rtol"] * 10, (p, d, want[p])


def test_check_gradient_catches_a_wrong_gradient(monkeypatch):
    """cos_sim with its denominator detached: the forward is unchanged, the
    gradient is not, and the check fails."""
    orig = treg.get_kernel("cos_sim")

    def detached_den(ctx):
        x, y = ctx.input("X"), ctx.input("Y")
        den = (x.norm(dim=-1, keepdim=True) * y.norm(dim=-1, keepdim=True)).detach()
        ctx.set_output("Out", ctx.attr("scale", 1.0) * (x * y).sum(-1, keepdim=True)
                       / den.clamp(min=1e-8))

    ptt.reset_default_programs()
    ptt.default_startup_program().random_seed = 5
    loss = _grad_program(ptt, "sum_cos_sim")
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(ptt.default_startup_program(), scope=scope)
    feed = _grad_feed("sum_cos_sim", ptt.LoDArray)
    ptt.check_gradient(loss, feed, scope=scope, device="cpu", **CHECK)
    monkeypatch.setitem(treg._KERNELS, "cos_sim", detached_den)
    assert treg.get_kernel("cos_sim") is not orig
    with pytest.raises(AssertionError, match="gradient mismatch"):
        ptt.check_gradient(loss, feed, scope=scope, device="cpu", **CHECK)
