"""The book's image_classification (tests/book/test_image_classification.py)
through the port, with the ops, models and loaders it needs, on the CPU,
against the JAX package.

- `dropout` in v0.11's semantics: test mode x·(1 − p) bit-equal to the
  JAX op (f32, on a LoD input whose LoD is kept); train mode with a given
  mask (`dropout_apply`, and the JAX op with its Bernoulli draw replaced
  by that mask) bit-equal; the port's own draw keeps each value or zeroes
  it, keeps a share within 4σ of 1 − p, and has the mask as its gradient.
  A window of a program drawing dropout gives the per-step loop's bits.
- `lrn` against the JAX op, forward and the gradient of a seeded
  cotangent, within 1e-6 relative (x^β through another pow).
- The zoo's programs (resnet_cifar10 20 and 32, vgg 11 and 16, alexnet,
  googlenet, smallnet, lenet) and transformer_lm(dropout_prob=0.1) built by
  both front ends to equal program dicts.
- Three Adam steps of resnet_cifar10(depth=8) at B=4 and vgg(11) at B=2
  (both packages' dropout kernels replaced, in the test only, by one that
  applies a fixed mask per op) from one state (resnet's the JAX
  startup's, vgg's the port's; REORDER_REL_L2 says why): costs within
  1e-5 relative, the first step's gradients within 1e-4 relative L2, and
  each parameter's update over the 3 steps within 5e-2 of the JAX one's
  in relative L2 (GRAD_REL_L2 says why). The port's resnet gradients are
  also held under a reordering of the batch.
- `cifar`, `sentiment`, `wmt14` and `wmt16` and `data.image`'s transforms
  against the JAX ones, on tests/fixtures/data and on synthetic data.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import models as jmodels
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu.data import image as jimage
from paddle_tpu.data.datasets import cifar as jcifar
from paddle_tpu.data.datasets import sentiment as jsentiment
from paddle_tpu.data.datasets import wmt14 as jwmt14
from paddle_tpu.data.datasets import wmt16 as jwmt16
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.data import image as timage
from paddle_tpu_torch.data.datasets import cifar, sentiment, wmt14, wmt16
from paddle_tpu_torch.ops import nn_ops

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "data")
RTOL = 1e-5
# The nets feed BN into ReLU and a conv into BN: the first step's
# gradients agree to 1e-5 (relative L2, measured up to 1.7e-5), but
# Adam's steps move an element by about lr·sign(g), and where BN's
# backward cancels g to near 0 (its scale-invariant directions,
# tests/test_torch_resnet.py's docstring) the two packages' f32 gradients,
# summed in other orders, differ in sign; the next steps' gradients
# amplify those moves. So each parameter's update over the 3 steps is held
# in relative L2 (measured up to 1.3e-2 for vgg, 7.1e-4 for resnet)
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 5e-2
# the port's gradient under a reordering of the batch. The JAX package's
# resnet_cifar10 stage-1 gradients move by up to 1.5e-2 under the same
# reordering from the port's startup draw (ROADMAP.md, queue C), so
# resnet's comparison runs from the JAX startup's state, as the book
# tests' do; vgg's from the port's
REORDER_REL_L2 = 1e-5
LRN_TOL = 1e-6


@pytest.fixture
def one_thread():
    """torch on one thread for the training steps, as tests/test_torch_book.py
    runs its own: the suite's workers share the host's cores, and eager
    steps of small ops on every core's thread slow each other many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op(reg, op_cls, op, env, ins, attrs, out="Out"):
    names = {slot: [slot] for slot in ins}
    env.update({"@AMP@": None, **ins})
    reg.get_kernel(op)(reg.OpContext(op_cls(op, names, {out: [out]}, dict(attrs)), env))
    return env[out]


# ---------------------------------------------------------------- dropout


def test_dropout_test_mode_bit_equal_jax():
    """x·(1 − p) on a LoD input: bit-equal in f32, the LoD kept."""
    rng = np.random.RandomState(1)
    seqs = [rng.randn(n, 6).astype(np.float32) for n in (3, 5, 1)]
    for p in (0.1, 0.5, 0.37):
        j = _op(jreg, JOp, "dropout", {}, {"X": JLoD.from_sequences(seqs, capacity=16,
                                                                    max_seqs=4)},
                {"dropout_prob": p, "is_test": True})
        tl = ptt.LoDArray.from_sequences(seqs, capacity=16, max_seqs=4)
        t = _op(treg, TOp, "dropout", {}, {"X": tl}, {"dropout_prob": p, "is_test": True})
        assert isinstance(t, ptt.LoDArray) and t.seq_ids is tl.seq_ids
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


def test_dropout_given_mask_bit_equal_jax(monkeypatch):
    """The JAX op with its Bernoulli draw replaced by a given mask, against
    `dropout_apply` on that mask: bit-equal, f32 and bf16, dense and LoD."""
    rng = np.random.RandomState(2)
    x = rng.randn(8, 12).astype(np.float32)
    mask = rng.rand(8, 12) < 0.6
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        j = _op(jreg, JOp, "dropout", {"@RNG@": jax.random.PRNGKey(0)},
                {"X": jnp.asarray(x).astype(jdt)}, {"dropout_prob": 0.4})
        t = nn_ops.dropout_apply(torch.as_tensor(x).to(tdt), torch.as_tensor(mask))
        assert t.dtype == tdt
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j).astype(np.float32))
    seqs = [x[:5], x[5:]]
    jl = JLoD.from_sequences(seqs, capacity=8, max_seqs=3)
    j = _op(jreg, JOp, "dropout", {"@RNG@": jax.random.PRNGKey(0)}, {"X": jl},
            {"dropout_prob": 0.4})
    tl = ptt.LoDArray.from_sequences(seqs, capacity=8, max_seqs=3)
    np.testing.assert_array_equal(nn_ops.dropout_apply(tl.data, torch.as_tensor(mask)).numpy(),
                                  np.asarray(j.data))


def test_dropout_draw_and_gradient():
    """The port's train-mode draw: each value kept or zeroed, the kept
    share within 4σ of 1 − p, the same draw from the same seed, the mask as
    the gradient, a LoD input's LoD kept."""
    x = torch.randn(256, 64) + 3.0  # no exact zeros
    for p in (0.5, 0.1):
        outs = []
        for _ in range(2):
            gen = torch.Generator().manual_seed(7)
            xl = x.clone().requires_grad_(True)
            out = _op(treg, TOp, "dropout", {"@RNG@": gen}, {"X": xl}, {"dropout_prob": p})
            (g,) = torch.autograd.grad(out.sum(), [xl])
            outs.append(out.detach())
        mask = outs[0] != 0
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(outs[0], nn_ops.dropout_apply(x, mask))
        assert torch.equal(g, mask.float())
        n = mask.numel()
        assert abs(float(mask.float().mean()) - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    tl = ptt.LoDArray.from_sequences([np.ones((3, 4), np.float32)], capacity=8, max_seqs=2)
    out = _op(treg, TOp, "dropout", {"@RNG@": torch.Generator().manual_seed(0)}, {"X": tl},
              {"dropout_prob": 0.5})
    assert isinstance(out, ptt.LoDArray) and out.lengths is tl.lengths


def _dropout_program(m):
    x = m.layers.data("x", shape=[16])
    y = m.layers.data("y", shape=[1])
    h = m.layers.dropout(m.layers.fc(x, size=32, act="relu"), 0.3)
    loss = m.layers.mean(m.layers.square_error_cost(m.layers.fc(h, size=1), y))
    m.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_dropout_window_equals_per_step():
    """A seeded program drawing dropout in its main program: 8 steps
    through Trainer(scan_window=4) against the per-step loop, the same
    bits (each step draws from the generator re-seeded as Executor.run
    seeds it)."""
    rng = np.random.RandomState(4)
    data = [{"x": rng.randn(8, 16).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)} for _ in range(8)]
    runs = {}
    for mode, kw in (("step", dict(log_interval=1)), ("window", dict(scan_window=4))):
        ptt.reset_default_programs()
        prog, startup = ptt.Program(), ptt.Program()
        prog.random_seed = startup.random_seed = 9
        with ptt.program_guard(prog, startup):
            loss = _dropout_program(ptt)
        t = ptt.Trainer(loss, main_program=prog, startup_program=startup, place="cpu",
                        scope=ptt.Scope())
        m = t.train(lambda: iter(data), 1, **kw)
        runs[mode] = (m, {p.name: t.scope.get(p.name).clone() for p in prog.parameters()})
    (ms, ps), (mw, pw) = runs["step"], runs["window"]
    assert ms == mw
    for n, v in ps.items():
        assert torch.equal(pw[n], v), n


# -------------------------------------------------------------------- lrn


def test_lrn_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 5, 4).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    for attrs in ({}, {"n": 3, "k": 1.0, "alpha": 0.01, "beta": 0.5}):
        def jf(v, attrs=attrs):
            return _op(jreg, JOp, "lrn", {}, {"X": v}, attrs)

        j, jg = jax.jit(lambda v, jf=jf: (lambda o, f: (o, f(jnp.asarray(cot))[0]))(
            *jax.vjp(jf, v)))(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        t = _op(treg, TOp, "lrn", {}, {"X": xt}, attrs)
        (tg,) = torch.autograd.grad(t, [xt], torch.tensor(cot))
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=LRN_TOL, atol=LRN_TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=LRN_TOL, atol=LRN_TOL)


# --------------------------------------------------------------- programs


def _image_model(name, **kw):
    def model(m):
        img = m.layers.data("img", shape=[3, 32, 32] if name not in ("alexnet", "googlenet")
                            else [3, 224, 224])
        label = m.layers.data("label", shape=[1], dtype=np.int32)
        models = ptt.models if m is ptt else jmodels
        logits = getattr(models, name)(img, class_dim=10, **kw)
        cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, label))
        acc = m.layers.accuracy(m.layers.softmax(logits), label)
        m.optimizer.Adam(learning_rate=1e-3).minimize(cost)
        return cost, acc

    return model


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


def _transformer(m):
    toks = m.layers.data("toks", shape=[16], dtype=np.int32)
    labels = m.layers.data("labels", shape=[16, 1], dtype=np.int32)
    models = ptt.models if m is ptt else jmodels
    logits = models.transformer_lm(toks, vocab_size=32, dim=32, num_heads=4, num_layers=2,
                                   max_len=16, dropout_prob=0.1)
    cost = m.layers.mean(m.layers.softmax_with_cross_entropy(logits, labels))
    m.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return cost, None


PROGRAMS = {"resnet_cifar10-20": _image_model("resnet_cifar10", depth=20),
            "resnet_cifar10-32": _image_model("resnet_cifar10", depth=32),
            "vgg-11": _image_model("vgg", depth=11), "vgg-16": _image_model("vgg", depth=16),
            "alexnet": _image_model("alexnet"), "googlenet": _image_model("googlenet"),
            "smallnet": _image_model("smallnet"), "lenet": _image_model("lenet"),
            "transformer_lm-dropout": _transformer}


@pytest.mark.parametrize("which", list(PROGRAMS))
def test_program_equals_jax(which):
    tp = _build(ptt, PROGRAMS[which])[0]
    assert tp.to_dict() == _build(pt, PROGRAMS[which])[0].to_dict()
    if which.startswith(("vgg", "alexnet", "transformer")):
        assert any(o.type == "dropout" for o in tp.global_block().ops)


# --------------------------------------------------- three steps against JAX


@pytest.fixture
def one_mask_dropout(monkeypatch):
    """Both packages' dropout kernels replaced by one applying a fixed
    mask a dropout op (by its output's name, drawn from a seeded
    RandomState on first use): the two packages draw different streams, so
    the training comparison feeds both the same mask."""
    masks = {}

    def mask_for(ctx, shape):
        name = ctx.op.outputs["Out"][0]
        if name not in masks:
            masks[name] = np.random.RandomState(len(masks) + 1).rand(*shape) >= 0.5
        return masks[name]

    def jdrop(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", x * jnp.asarray(mask_for(ctx, x.shape)).astype(x.dtype))

    def tdrop(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", nn_ops.dropout_apply(x, torch.as_tensor(mask_for(ctx, x.shape))))

    monkeypatch.setitem(jreg._KERNELS, "dropout", jdrop)
    monkeypatch.setitem(treg._KERNELS, "dropout", tdrop)
    return masks


TRAIN = {"resnet_cifar10-8": (_image_model("resnet_cifar10", depth=8), 4),
         "vgg-11": (_image_model("vgg", depth=11), 2)}


@pytest.mark.parametrize("which", list(TRAIN))
def test_three_steps_equal_jax(one_thread, which, one_mask_dropout):
    model, batch = TRAIN[which]
    jprog, jstartup, jcost, jacc = _build(pt, model)
    tprog, tstartup, _, _ = _build(ptt, model)
    jexe, js, texe, tscope, state = _one_state(jstartup if which.startswith("resnet") else None,
                                               tprog, tstartup)
    rng = np.random.RandomState(5)
    feeds = [{"img": rng.rand(batch, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (batch, 1)).astype(np.int32)} for _ in range(3)]
    if which.startswith("resnet"):  # vgg's fixed masks make the order matter
        _hold_reordering(tprog, tstartup, state, feeds[0])
    worst = {"grad": 0.0, "update": 0.0}
    for i, feed in enumerate(feeds):
        jout = jexe.run(jprog, feed=feed, fetch_list=[jcost, jacc])
        tout = texe.run(tprog, feed, [jcost.name, jacc.name], scope=tscope)
        for j, t in zip(jout, tout):
            np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=RTOL * abs(float(j)))
        if i == 0:  # the first step's gradients: Adam's first moments, (1 − β1)·g
            for n in state:
                if ".moment1." in n:
                    worst["grad"] = max(worst["grad"], _rel_l2(tscope.get(n).numpy(),
                                                               np.asarray(js.get(n))))
    if which.startswith("vgg"):
        assert len(one_mask_dropout) == 2
    for p in tprog.parameters():
        want = np.asarray(js.get(p.name))
        worst["update"] = max(worst["update"], _rel_l2(tscope.get(p.name).numpy() - state[p.name],
                                                       want - state[p.name]))
    assert worst["grad"] <= GRAD_REL_L2 and worst["update"] <= UPDATE_REL_L2, worst


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _one_state(jstartup, tprog, tstartup):
    """One state in both scopes: the JAX startup's where `jstartup` is
    given, else the port's (the JAX side's global scope takes it as it is,
    sparing the compile of every initializer: 5 s for vgg's 30M values)."""
    jexe, js = pt.Executor(), pt.global_scope()
    texe, tscope = ptt.Executor(device="cpu"), ptt.Scope()
    texe.run(tstartup, scope=tscope)
    names = [v.name for v in tprog.persistables() if tscope.has(v.name)]
    if jstartup is not None:
        jexe.run(jstartup)
        state = {n: np.array(np.asarray(js.get(n))) for n in names}
        tio.params_from_numpy(tscope, state, "cpu")
    else:
        state = tio.state_to_numpy(tscope, names)
        for n, v in state.items():
            js.set(n, jnp.asarray(v))
    return jexe, js, texe, tscope, state


def _hold_reordering(tprog, tstartup, state, feed):
    """The port's first step from `state` on `feed` and on `feed` with its
    batch reversed (a symmetry of the loss: a mean over the batch, BN over
    it): every parameter's gradient (Adam's first moment, (1 − β1)·g) the
    same within 1e-5 relative in L2."""
    moments = []
    for order in (slice(None), slice(None, None, -1)):
        exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
        exe.run(tstartup, scope=scope)
        tio.params_from_numpy(scope, state, "cpu")
        exe.run(tprog, {k: v[order].copy() for k, v in feed.items()}, [], scope=scope)
        moments.append({n: scope.get(n).numpy() for n in state if ".moment1." in n})
    for n, a in moments[0].items():
        b = moments[1][n]
        assert np.linalg.norm(a - b) <= REORDER_REL_L2 * np.linalg.norm(a), n


# ------------------------------------------------------------ the loaders


def test_simple_transform_equals_jax():
    """The book's _augment (resize 36, a random 32-crop, a coin-flip mirror)
    and the test path (centre crop, a mean), from the same RandomStates."""
    rng = np.random.RandomState(6)
    hwc = rng.rand(32, 32, 3).astype(np.float32)
    u8 = (rng.rand(40, 30, 3) * 255).astype(np.uint8)
    for seed in range(6):
        for im, kw in ((hwc, dict(resize_size=36, crop_size=32, is_train=True)),
                       (u8, dict(resize_size=36, crop_size=28, is_train=True)),
                       (u8, dict(resize_size=32, crop_size=24, is_train=False,
                                 mean=[1.0, 2.0, 3.0]))):
            a = timage.simple_transform(im, rng=np.random.RandomState(seed), **kw)
            b = jimage.simple_transform(im, rng=np.random.RandomState(seed), **kw)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(timage.resize_short(u8, 17), jimage.resize_short(u8, 17))
    np.testing.assert_array_equal(timage.left_right_flip(u8), jimage.left_right_flip(u8))


def _same(got, want):
    """Two readers' samples equal field by field (arrays stacked)."""
    g, w = list(got()), list(want())
    assert len(g) == len(w) > 0
    for field in range(len(g[0])):
        a, b = [s[field] for s in g], [s[field] for s in w]
        if isinstance(a[0], np.ndarray):
            np.testing.assert_array_equal(np.stack(a), np.stack(b))
        else:
            assert a == b
    return g


def test_loaders_read_the_fixtures(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", FIXTURES)
    g = _same(cifar.train10(), jcifar.train10())
    assert g[0][0].shape == (3072,) and g[0][0].dtype == np.float32
    _same(cifar.test10(), jcifar.test10())
    for size in (30, 1000):
        _same(wmt14.train(size), jwmt14.train(size))
        _same(wmt14.test(size), jwmt14.test(size))
        for rev in (False, True):
            assert wmt14.get_dict(size, rev) == jwmt14.get_dict(size, rev)


def test_loaders_synthetic_equal_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / "empty"))
    for got, want, n in ((cifar.train10(), jcifar.train10(), 4000),
                         (cifar.test100(), jcifar.test100(), 800),
                         (sentiment.train(), jsentiment.train(), 1600),
                         (sentiment.test(), jsentiment.test(), 400),
                         (wmt14.train(64), jwmt14.train(64), 3000),
                         (wmt16.train(50, 70), jwmt16.train(50, 70), 3000),
                         (wmt16.test(80, 60), jwmt16.test(80, 60), 300)):
        assert len(_same(got, want)) == n
    assert sentiment.get_word_dict() == jsentiment.get_word_dict()
    assert wmt14.get_dict(40) == jwmt14.get_dict(40)
    assert wmt16.get_dict("en", 40, True) == jwmt16.get_dict("en", 40, True)
