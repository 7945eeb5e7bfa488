"""Eval-mode ResNet-50 (A6a) against the JAX package: bench.py's
`resnet_infer` program (run_infer, bench.py:754-838: NHWC 224x224x3, 1000
classes, is_test) and `__graft_entry__.entry`'s NCHW is_test program
(`__graft_entry__.py:117-145`) built by both front ends with equal dicts;
a small eval-mode artifact (64x64, B=4, 1000 classes: 4000 logits) saved
by each package and loaded in the other with equal logits; and the weights
of the fused training route bound by name into the eval program.

Tolerances: f32 logits within 1e-5 of the largest logit (the same f32
arithmetic in other orders over 53 layers: measured 7e-7). bf16: both
packages round each conv and BN output to bf16, with other conv
implementations (oneDNN, XLA), and over 53 layers a flip travels through
the residual stream: measured, 42% of the logits lie more than one bf16
ulp (of the JAX value) apart and the largest difference is 7.2e-3 of the
largest logit, where the f32 program rounded once at its output reads 37%
and 1.3e-2 against the JAX bf16 logits (43% and 6.4e-3 with XLA's excess
precision off). So the bf16 check tells a working artifact from a broken
one, not a misplaced rounding (the f32 check holds the arithmetic): at most
BF16_SHARE of the logits beyond one ulp and every logit within BF16_REL of
the largest, beside what a zero output reads (1.0 and 1.0).
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import models as jmodels

SMALL = dict(hw=64, batch=4, class_dim=10)
CROSS = dict(SMALL, class_dim=1000)
F32_REL = 1e-5
BF16_SHARE, BF16_REL = 0.6, 3e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Full-depth ResNet-50 on the CPU: at most 4 of torch's threads, so
    the module leaves cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _eval_program(m, hw=224, class_dim=1000, fmt="NHWC"):
    if m is pt:
        pt.reset()
        models = jmodels
    else:
        ptt.reset_default_programs()
        models = ptt.models
    prog, startup = m.Program(), m.Program()
    with m.program_guard(prog, startup):
        shape = [hw, hw, 3] if fmt == "NHWC" else [3, hw, hw]
        img = m.layers.data("img", shape=shape)
        logits = models.resnet_imagenet(img, class_dim=class_dim, is_test=True,
                                        data_format=fmt)
    return prog, startup, logits


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_eval_programs_equal_jax(fmt):
    t = _eval_program(ptt, fmt=fmt)[0].to_dict()
    assert t == _eval_program(pt, fmt=fmt)[0].to_dict()
    types = {op["type"] for op in t["blocks"][0]["ops"]}
    assert "fused_conv_bn" not in types and "batch_norm" in types


def _seeded_state(prog, seed):
    """normal/sqrt(fan_in) weights, BN scales near 1, running statistics
    away from their initial 0 and 1, so eval-mode BN reads them."""
    rng = np.random.RandomState(seed)
    out = {}
    for v in prog.persistables():
        shape = tuple(v.shape)
        if v.name.endswith(".mean"):
            a = 0.1 * rng.randn(*shape)
        elif v.name.endswith(".variance"):
            a = 1 + 0.2 * rng.rand(*shape)
        elif v.name.endswith("_bn.w_0"):
            a = 1 + 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            a = 0.05 * rng.randn(*shape)
        else:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            a = rng.randn(*shape) / np.sqrt(fan_in)
        out[v.name] = a.astype(np.float32)
    return out


def _image(seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(SMALL["batch"], SMALL["hw"], SMALL["hw"], 3).astype(np.float32)


def _save(pkg, d, amp, state):
    prog, startup, logits = _eval_program(pkg, CROSS["hw"], CROSS["class_dim"])
    if amp:
        prog.set_amp(amp)
    if pkg is pt:
        for n, a in state.items():
            pt.global_scope().set(n, a)
        pt.io.save_inference_model(d, ["img"], [logits], main_program=prog)
    else:
        sc = ptt.Scope()
        ptt.io.params_from_numpy(sc, state, "cpu")
        ptt.io.save_inference_model(d, ["img"], [logits], main_program=prog, scope=sc)


def _load_run(pkg, d, amp, img):
    if pkg is pt:
        pt.reset()
        prog, feeds, fetches = pt.io.load_inference_model(d)
        prog.set_amp(amp)
        (out,) = pt.Executor().run(prog, {feeds[0]: img}, fetches)
        return np.asarray(out, np.float32)
    sc = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(d, scope=sc, device="cpu")
    prog.set_amp(amp)
    (out,) = ptt.Executor(device="cpu").run(prog, {feeds[0]: img}, fetches, scope=sc)
    return np.asarray(out, np.float32)


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def _reading(got, want):
    """(largest error over the largest logit, share of logits more than one
    bf16 ulp apart)."""
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    share = float(np.mean(np.abs(got - want) > _bf16_ulp(want)))
    return rel, share


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_artifact_crosses_packages(tmp_path, amp):
    """Each package saves the artifact from one state; the two artifacts
    hold the same program and parameters, the port serves the JAX
    package's and the JAX package serves the port's, with equal logits."""
    prog = _eval_program(ptt, CROSS["hw"], CROSS["class_dim"])[0]
    state = _seeded_state(prog, seed=3)
    dirs = {name: str(tmp_path / name) for name in ("jax", "port")}
    _save(pt, dirs["jax"], amp, state)
    _save(ptt, dirs["port"], amp, state)
    with open(f"{dirs['jax']}/program.json") as fj, open(f"{dirs['port']}/program.json") as ft:
        assert json.load(fj) == json.load(ft)
    with np.load(f"{dirs['jax']}/params.npz") as pj, np.load(f"{dirs['port']}/params.npz") as pp:
        assert sorted(pj.files) == sorted(pp.files)
        for n in pj.files:
            np.testing.assert_array_equal(pp[n], pj[n])
    img = _image()
    want = _load_run(pt, dirs["port"], amp, img)
    got = _load_run(ptt, dirs["jax"], amp, img)
    assert got.shape == want.shape == (CROSS["batch"], CROSS["class_dim"])
    rel, share = _reading(got, want)
    zero = _reading(np.zeros_like(want), want)
    assert zero == (1.0, 1.0)
    if amp is None:
        assert rel <= F32_REL, rel
    else:
        assert share <= BF16_SHARE and rel <= BF16_REL, (share, rel)


def bind_trained(eval_prog, train_prog, train_scope):
    """{name: value} for every persistable of the eval program from the
    training scope: by name (`_cbn_attrs` names every conv and BN pair
    alike in the fused training graph and the unfused eval graph), and the
    parameters whose automatic names differ (the classifier's fc) in the
    order both programs create them, shapes checked."""
    bound = {n.name: train_scope.get(n.name) for n in eval_prog.persistables()
             if train_scope.has(n.name)}
    left = [v for v in eval_prog.persistables() if v.name not in bound]
    spare = [v for v in train_prog.parameters()
             if v.name not in bound and train_scope.has(v.name)]
    assert len(left) == len(spare), ([v.name for v in left], [v.name for v in spare])
    for e, t in zip(left, spare):
        assert tuple(e.shape) == tuple(t.shape), (e.name, t.name)
        bound[e.name] = train_scope.get(t.name)
    return bound, len(left)


def test_fused_route_weights_bind_into_the_eval_program(monkeypatch):
    """Two Momentum steps of the small fused NHWC program (the B11 route's
    plain version on the CPU) through the port's Trainer; its weights,
    bound into the eval program, give the logits the JAX eval program
    gives on the same weights."""
    monkeypatch.setattr(ptt.FLAGS, "fused_conv_dot_max_n", 10 ** 9)
    monkeypatch.setattr(ptt.FLAGS, "fused_conv_pallas", True)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        img = ptt.layers.data("img", shape=[SMALL["hw"], SMALL["hw"], 3])
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        logits = ptt.models.resnet_imagenet(img, class_dim=SMALL["class_dim"],
                                            data_format="NHWC")
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.Momentum(learning_rate=1e-3, momentum=0.9).minimize(loss)
    assert "fused_conv_bn" in {op.type for op in main.global_block().ops}
    rng = np.random.RandomState(0)
    samples = [(rng.randn(SMALL["hw"], SMALL["hw"], 3).astype(np.float32),
                [int(rng.randint(SMALL["class_dim"]))]) for _ in range(8)]
    sc = ptt.Scope()
    trainer = ptt.Trainer(loss, main_program=main, startup_program=startup, place="cpu",
                          scope=sc)
    trainer.init()
    before = {v.name: sc.get(v.name).clone() for v in main.persistables()}
    trainer.train(ptt.data.batch(lambda: iter(samples), SMALL["batch"]), 1,
                  feed_order=[img, label])
    moved = [n for n, v in before.items() if not torch.equal(v, sc.get(n))]
    assert any(n.endswith(".mean") for n in moved) and any(n.endswith(".w_0") for n in moved)

    eprog, _, elogits = _eval_program(ptt, SMALL["hw"], SMALL["class_dim"])
    bound, by_order = bind_trained(eprog, main, sc)
    assert by_order == 2 and len(bound) == len(eprog.persistables())
    esc = ptt.Scope()
    for n, v in bound.items():
        esc.set(n, v)
    x = _image(seed=4)
    (got,) = ptt.Executor(device="cpu").run(eprog, {"img": x}, [elogits], scope=esc)
    jprog, _, jlogits = _eval_program(pt, SMALL["hw"], SMALL["class_dim"])
    for n, v in bound.items():
        pt.global_scope().set(n, v.numpy())
    (want,) = pt.Executor().run(jprog, {"img": x}, [jlogits])
    rel, _ = _reading(np.asarray(got), np.asarray(want))
    assert rel <= F32_REL, rel
