"""The cost and misc ops and every new layer against the JAX package.

`test_layer_sweep` mirrors tests/test_layer_grad_sweep.py's CASES for the
layers of layers/misc.py, layers/ctc.py and layers/detection.py: each
builder runs under both front ends (the same program dict), on the same
numpy weights and feeds, and the loss and every parameter's gradient agree
within 1e-5 of each fetch's scale (its largest |value|, at least 1e-3) in
f32. `nce`'s negatives and `sampling_id`'s draws are fixed on both sides,
the JAX draw replaced through monkeypatch as tests/test_torch_book_image.py
fixes dropout's mask. The op tests run each op through both packages'
OpContexts (tests/test_torch_ops_general.py's `run_both`) within 1e-5 of
each output's scale (its largest |value|, at least 1); integer outputs
are equal. `test_every_layer_is_covered` holds the cases and exemptions to
`paddle_tpu_torch.layers.__all__`, which is the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import cost_ops, misc_ops

from test_torch_ops_general import (Lod, assert_same, forward_both, one_thread,  # noqa: F401
                                    run_both)

TOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _x(shape, scale=0.5, seed=0):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _scalar(m, v):
    return m.layers.mean(m.layers.elementwise_mul(v, v))


def _pre(m, d=6, name="x"):
    """data [d] -> trainable fc(d), so the layer's VJP reaches a weight."""
    return m.layers.fc(m.layers.data(name, shape=[d]), size=d)


def _pre4(m, c=2, h=6, w=6, n=2):
    """[n, c, h, w] through a trainable fc."""
    x = m.layers.data("x", shape=[c * h * w])
    return m.layers.reshape(m.layers.fc(x, size=c * h * w), (n, c, h, w))


def _pre_seq(m, d=6, vocab=11, name="ids"):
    ids = m.layers.data(name, shape=[-1], dtype=np.int32, lod_level=1,
                        append_batch_size=False)
    return m.layers.embedding(ids, size=[vocab, d])


def _ids_feed(lens=(4, 2), vocab=11, seed=0):
    rng = _rng(seed)
    return Lod([rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens])


def _lbl(m, shape=(1,), dtype=np.float32, name="lbl"):
    return m.layers.data(name, shape=list(shape), dtype=dtype)


def _unary(fn, **kw):
    return lambda m: _scalar(m, getattr(m.layers, fn)(_pre(m), **kw))


def _pre4_case(fn, dims, **kw):
    return lambda m: _scalar(m, getattr(m.layers, fn)(_pre4(m, *dims), **kw))


# {layer: (builder(package) -> loss, feed)}: the JAX sweep's cases
CASES = {
    "row_l2_norm": (_unary("row_l2_norm"), {}),
    "l2_normalize": (_unary("l2_normalize"), {}),
    "slope_intercept": (_unary("slope_intercept", slope=-0.7, intercept=0.3), {}),
    "sum_cost": (lambda m: m.layers.sum_cost(_pre(m)), {}),
    "pad": (_unary("pad", paddings=[1, 0, 2, 1], pad_value=0.5), {}),
    "crop": (_unary("crop", offsets=(1, 2), shape=(2, 3)), {}),
    "prelu": (_unary("prelu", mode="channel"), {}),
    "prelu_all": (_unary("prelu", mode="all"), {}),
    "prelu_element": (_unary("prelu", mode="element"), {}),
    "scale_shift": (_unary("scale_shift"), {}),
    "sum_to_one_norm": (lambda m: _scalar(m, m.layers.sum_to_one_norm(
        m.layers.sigmoid(_pre(m)))), {}),
    "gather": (lambda m: _scalar(m, m.layers.gather(_pre(m), m.layers.data(
        "idx", shape=[4], dtype=np.int32, append_batch_size=False))),
        {"idx": np.array([2, 0, 2, 1], np.int32)}),
    "scatter": (lambda m: _scalar(m, m.layers.scatter(
        m.layers.data("base", shape=[4, 6], append_batch_size=False),
        m.layers.data("idx", shape=[3], dtype=np.int32, append_batch_size=False), _pre(m))),
        {"base": _x((4, 6), seed=1), "idx": np.array([1, 3, 0], np.int32)}),
    "scatter_add": (lambda m: _scalar(m, m.layers.scatter(
        m.layers.data("base", shape=[4, 6], append_batch_size=False),
        m.layers.data("idx", shape=[3], dtype=np.int32, append_batch_size=False), _pre(m),
        overwrite=False)),
        {"base": _x((4, 6), seed=1), "idx": np.array([1, 3, 1], np.int32)}),
    "multiplex": (lambda m: (lambda h: _scalar(m, m.layers.multiplex(
        [h, m.layers.tanh(h)], m.layers.data("sel", shape=[3], dtype=np.int32,
                                             append_batch_size=False))))(_pre(m)),
        {"sel": np.array([0, 1, 0], np.int32)}),
    "cos_sim": (lambda m: (lambda h: _scalar(m, m.layers.cos_sim(h, m.layers.tanh(h))))(
        _pre(m)), {}),
    "dot_prod": (lambda m: (lambda h: _scalar(m, m.layers.dot_prod(h, m.layers.tanh(h))))(
        _pre(m)), {}),
    "out_prod": (lambda m: (lambda h: _scalar(m, m.layers.out_prod(h, m.layers.tanh(h))))(
        _pre(m, 4)), {"x": _x((3, 4))}),
    "l2_distance": (lambda m: (lambda h: _scalar(m, m.layers.l2_distance(
        h, m.layers.tanh(h))))(_pre(m)), {}),
    "conv_shift": (lambda m: (lambda h: _scalar(m, m.layers.conv_shift(
        h, m.layers.fc(h, size=3))))(_pre(m)), {}),
    "interpolation": (lambda m: (lambda h: _scalar(m, m.layers.interpolation(
        h, m.layers.tanh(h), m.layers.sigmoid(m.layers.fc(h, size=1)))))(_pre(m)), {}),
    "power": (lambda m: (lambda h: _scalar(m, m.layers.power(
        m.layers.scale(m.layers.sigmoid(h), bias=0.5),
        m.layers.sigmoid(m.layers.fc(h, size=1)))))(_pre(m)), {}),
    "scaling": (lambda m: (lambda h: _scalar(m, m.layers.scaling(
        h, m.layers.fc(h, size=1))))(_pre(m)), {}),
    "convex_comb": (lambda m: (lambda h: _scalar(m, m.layers.convex_comb(
        h, m.layers.softmax(m.layers.fc(h, size=3)))))(_pre(m)), {}),
    "bilinear_tensor_product": (lambda m: (lambda h: _scalar(
        m, m.layers.bilinear_tensor_product(h, m.layers.tanh(h), size=2)))(_pre(m, 4)),
        {"x": _x((3, 4))}),
    "factorization_machine": (lambda m: _scalar(m, m.layers.factorization_machine(
        _pre(m), factor_size=3)), {}),
    "selective_fc": (lambda m: _scalar(m, m.layers.selective_fc(
        _pre(m), size=4, mask=m.layers.data("mask", shape=[3, 4], append_batch_size=False))),
        {"mask": np.array([[1, 0, 1, 1]] * 3, np.float32)}),
    "smooth_l1": (lambda m: _scalar(m, m.layers.smooth_l1(_pre(m, 4), _lbl(m, (4,)))),
                  {"x": _x((3, 4)), "lbl": _x((3, 4), seed=2)}),
    "smooth_l1_weighted": (lambda m: _scalar(m, m.layers.smooth_l1(
        _pre(m, 4), _lbl(m, (4,)), inside_weight=_lbl(m, (4,), name="iw"),
        outside_weight=_lbl(m, (4,), name="ow"), sigma=2.0)),
        {"x": _x((3, 4)), "lbl": _x((3, 4), seed=2), "iw": np.abs(_x((3, 4), seed=3)),
         "ow": np.abs(_x((3, 4), seed=4))}),
    "huber_regression_cost": (lambda m: _scalar(m, m.layers.huber_regression_cost(
        _pre(m, 4), _lbl(m, (4,)), delta=1.0)), {"x": _x((3, 4)), "lbl": _x((3, 4), 2.0, 2)}),
    "huber_classification_cost": (lambda m: _scalar(m, m.layers.huber_classification_cost(
        m.layers.fc(_pre(m, 1), size=1), _lbl(m))),
        {"x": _x((3, 1), 2.0), "lbl": np.array([[1.0], [0.0], [1.0]], np.float32)}),
    "binary_cross_entropy": (lambda m: _scalar(m, m.layers.binary_cross_entropy(
        m.layers.sigmoid(m.layers.fc(_pre(m, 4), size=1)), _lbl(m))),
        {"x": _x((3, 4)), "lbl": np.array([[1.0], [0.0], [1.0]], np.float32)}),
    "sigmoid_cross_entropy_with_logits": (lambda m: _scalar(
        m, m.layers.sigmoid_cross_entropy_with_logits(_pre(m, 4), _lbl(m, (4,)))),
        {"x": _x((3, 4)), "lbl": _rng().randint(0, 2, (3, 4)).astype(np.float32)}),
    "cross_entropy_with_selfnorm": (lambda m: _scalar(m, m.layers.cross_entropy_with_selfnorm(
        m.layers.scale(m.layers.sigmoid(_pre(m, 5)), bias=0.1), _lbl(m, dtype=np.int32))),
        {"x": _x((3, 5)), "lbl": np.array([[0], [3], [2]], np.int32)}),
    "rank_cost": (lambda m: (lambda h: _scalar(m, m.layers.rank_cost(
        m.layers.sigmoid(m.layers.fc(h, size=1)), m.layers.sigmoid(m.layers.fc(h, size=1)),
        _lbl(m))))(_pre(m, 4)),
        {"x": _x((3, 4)), "lbl": np.array([[1.0], [0.0], [0.5]], np.float32)}),
    "margin_rank_loss": (lambda m: (lambda h: _scalar(m, m.layers.margin_rank_loss(
        m.layers.fc(h, size=1), m.layers.fc(h, size=1), _lbl(m), margin=0.1)))(_pre(m, 4)),
        {"x": _x((3, 4)), "lbl": np.array([[1.0], [-1.0], [1.0]], np.float32)}),
    "lambda_cost": (lambda m: _scalar(m, m.layers.lambda_cost(
        m.layers.fc(_pre(m), size=4), _lbl(m, (4,)), NDCG_num=4)),
        {"x": _x((2, 6)), "lbl": np.array([[3, 2, 1, 0], [0, 1, 2, 3]], np.float32)}),
    "lambda_cost_masked": (lambda m: _scalar(m, m.layers.lambda_cost(
        m.layers.scale(m.layers.fc(_pre(m), size=4), scale=0.1), _lbl(m, (4,)),
        mask=_lbl(m, (4,), name="mask"), NDCG_num=2)),
        {"x": _x((2, 6)), "lbl": np.array([[3, 2, 1, 0], [0, 1, 2, 3]], np.float32),
         "mask": np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)}),
    "nce": (lambda m: _scalar(m, m.layers.nce(_pre(m), _lbl(m, dtype=np.int32),
                                              num_classes=7, num_neg_samples=3)),
            {"x": _x((4, 6)), "lbl": np.array([[0], [3], [2], [1]], np.int32)}),
    "hsigmoid": (lambda m: _scalar(m, m.layers.hsigmoid(_pre(m), _lbl(m, dtype=np.int32),
                                                        num_classes=7)),
                 {"x": _x((4, 6)), "lbl": np.array([[0], [3], [6], [1]], np.int32)}),
    "conv3d": (lambda m: _scalar(m, m.layers.conv3d(m.layers.data("x", shape=[2, 3, 4, 4]),
                                                    num_filters=2, filter_size=3, padding=1)),
               {"x": _x((2, 2, 3, 4, 4))}),
    "pool3d": (lambda m: _scalar(m, m.layers.pool3d(m.layers.conv3d(
        m.layers.data("x", shape=[2, 3, 4, 4]), num_filters=2, filter_size=1), pool_size=2,
        pool_type="avg")), {"x": _x((2, 2, 3, 4, 4))}),
    "pool3d_max_padded": (lambda m: _scalar(m, m.layers.pool3d(m.layers.conv3d(
        m.layers.data("x", shape=[2, 3, 4, 4]), num_filters=2, filter_size=1), pool_size=3,
        pool_stride=2, pool_padding=1)), {"x": _x((2, 2, 3, 4, 4))}),
    "pool3d_avg_padded": (lambda m: _scalar(m, m.layers.pool3d(m.layers.conv3d(
        m.layers.data("x", shape=[2, 3, 4, 4]), num_filters=2, filter_size=1), pool_size=3,
        pool_type="avg", pool_stride=2, pool_padding=1)), {"x": _x((2, 2, 3, 4, 4))}),
    "maxout": (_pre4_case("maxout", (4, 4, 4), groups=2), {"x": _x((2, 64))}),
    "rotate": (_pre4_case("rotate", (2, 3, 4)), {"x": _x((2, 24))}),
    "switch_order": (_pre4_case("switch_order", (2, 3, 4)), {"x": _x((2, 24))}),
    "bilinear_interp": (_pre4_case("bilinear_interp", (2, 4, 4), out_h=7, out_w=5),
                        {"x": _x((2, 32))}),
    "im2sequence": (_pre4_case("im2sequence", (2, 5, 5), block_y=2, block_x=3, stride_y=1,
                               stride_x=2, padding_y=1, padding_x=0), {"x": _x((2, 50))}),
    "spp": (lambda m: _scalar(m, m.layers.spp(_pre4(m, 2, 6, 6, 1), pyramid_height=2,
                                              pool_type="avg")), {"x": _x((1, 72))}),
    "spp_max": (lambda m: _scalar(m, m.layers.spp(_pre4(m, 2, 7, 5, 1), pyramid_height=3)),
                {"x": _x((1, 70))}),
    "roi_pool": (lambda m: _scalar(m, m.layers.roi_pool(
        _pre4(m, 2, 8, 8, 1), m.layers.data("rois", shape=[3, 5], append_batch_size=False),
        pooled_height=2, pooled_width=3)),
        {"x": _x((1, 128)),
         "rois": np.array([[0, 0, 0, 5, 5], [0, 2, 2, 7, 7], [0, 6, 1, 7, 2]], np.float32)}),
    "scale_sub_region": (_pre4_case("scale_sub_region", (2, 4, 4), indices=[1, 1, 2, 3, 2, 3],
                                    scale=2.0), {"x": _x((2, 32))}),
    "row_conv": (lambda m: _scalar(m, m.layers.sequence_pool(m.layers.row_conv(
        _pre_seq(m), future_context_size=2), "sum")), {"ids": _ids_feed((4, 2, 3))}),
    "warpctc": (lambda m: _scalar(m, m.layers.warpctc(
        m.layers.fc(_pre_seq(m, 6, 9), size=5), m.layers.data(
            "lbl", shape=[-1], dtype=np.int32, lod_level=1, append_batch_size=False),
        blank=0, max_len=8, max_label_len=4)),
        {"ids": _ids_feed((6, 4), 9), "lbl": Lod([np.array([1, 3], np.int32),
                                                  np.array([2, 2], np.int32)])}),
    "multibox_loss": (lambda m: _scalar(m, m.layers.multibox_loss(
        m.layers.fc(m.layers.data("feat", shape=[8]), size=16),
        m.layers.fc(m.layers.data("feat", shape=[8]), size=12),
        m.layers.data("priors", shape=[4]), m.layers.data("pvar", shape=[4]),
        m.layers.data("gt", shape=[1, 4]), m.layers.data("gtl", shape=[1], dtype=np.int32),
        overlap_threshold=0.3)),
        {"feat": _x((1, 8)),
         "priors": np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                             [0.2, 0.2, 0.6, 0.6], [0.6, 0.1, 0.9, 0.4]], np.float32),
         "pvar": np.full((4, 4), 0.1, np.float32),
         "gt": np.array([[[0.12, 0.1, 0.42, 0.4]]], np.float32),
         "gtl": np.array([[1]], np.int32)}),
}

# layers without a gradient case: what they compute is held elsewhere
EXEMPT = {
    "one_hot": "integer input: test_one_hot_and_integer_ops",
    "sampling_id": "a draw: test_sampling_id_given_draws (the draw fixed on both sides)",
    "ctc_greedy_decoder": "decode only: tests/test_torch_ctc.py",
    "detection_output": "decode only: tests/test_torch_detection.py",
    "prior_box": "constant priors: tests/test_torch_detection.py",
    "num_priors": "an int from the configuration: tests/test_torch_detection.py",
    "GenSpec": "generation plumbing, held in tests/test_torch_generation.py",
    "DecodeState": "generation plumbing, held in tests/test_torch_generation.py",
    "beam_step": "generation plumbing, held in tests/test_torch_generation.py",
    "find_generation_op": "generation plumbing, held in tests/test_torch_generation.py",
    "gen_spec_from_op": "generation plumbing, held in tests/test_torch_generation.py",
}

# the layers of earlier slices, each held against the JAX package in the
# tests of its slice
EARLIER = {n for mod in ("nn", "sequence", "attention", "crf", "recurrent", "control_flow")
           for n in getattr(ptt.layers, mod).__all__} | {"BeamSearchDecoder"}


@pytest.fixture
def fixed_draws(monkeypatch):
    """nce's negatives and sampling_id's ids, the same on both sides."""
    neg = _rng(7).randint(0, 7, (4, 3)).astype(np.int32)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(neg))
    monkeypatch.setattr(cost_ops, "draw_negatives",
                        lambda gen, n, k, c: torch.as_tensor(neg).long())
    return neg


def _feed_for(name):
    feed = dict(CASES[name][1])
    if not any(k in feed for k in ("x", "feat", "ids")):
        feed["x"] = _x((3, 6))
    return feed


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_sweep(name, fixed_draws, one_thread):
    """The loss and every parameter's gradient, port against JAX, f32."""
    j, t = forward_both(CASES[name][0], _feed_for(name), grads=True)
    assert len(j) == len(t) > 1
    for a, b in zip(j, t):
        a = np.asarray(a, np.float32)
        scale = max(1e-3, float(np.abs(a).max()))
        np.testing.assert_allclose(np.asarray(b, np.float32), a, rtol=0, atol=TOL * scale)


def test_every_layer_is_covered():
    public = set(ptt.layers.__all__)
    assert public == set(pt.layers.__all__) and len(ptt.layers.__all__) == len(public) == 140
    variants = {n for n in CASES if n not in public}
    assert all(any(n.startswith(p + "_") for p in public) for n in variants)
    covered = (set(CASES) - variants) | set(EXEMPT) | EARLIER
    assert not public - covered, f"layers without a case: {sorted(public - covered)}"
    assert not covered - public, f"stale entries: {sorted(covered - public)}"
    assert not (set(CASES) & set(EXEMPT)) and not (set(CASES) & EARLIER)


def test_sampling_id_given_draws(monkeypatch):
    """The JAX op's categorical draw replaced by given ids, the port's by
    the same: the program's output equal. And the port's own draw: each id
    a column whose probability is not 0, frequencies within 5σ of p."""
    ids = np.array([2, 0, 1], np.int32)
    draw = misc_ops.sample_ids
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1: jnp.asarray(ids))
    monkeypatch.setattr(misc_ops, "sample_ids", lambda p, gen: torch.as_tensor(ids))
    j, t = forward_both(lambda m: m.layers.sampling_id(m.layers.softmax(_pre(m, 3))),
                        {"x": _x((3, 3))})
    np.testing.assert_array_equal(t[0], np.asarray(j[0]))
    p = torch.tensor([[0.1, 0.0, 0.6, 0.3]] * 4000)
    gen = torch.Generator().manual_seed(0)
    got = draw(p, gen)
    assert got.dtype == torch.int32 and not (got == 1).any()
    freq = torch.bincount(got.long(), minlength=4).double() / got.numel()
    sigma = torch.sqrt(p[0].double() * (1 - p[0].double()) / got.numel())
    assert bool(((freq - p[0].double()).abs() <= 5 * sigma + 1e-12).all())


def test_one_hot_and_integer_ops():
    """one_hot (an id past depth gives zeros), and gather and multiplex
    of int tensors: equal."""
    x = np.array([[0], [3], [5], [1]], np.int32)
    (j, t), = run_both("one_hot", {"X": [x]}, {"depth": 4})["Out"]
    assert_same(j, t, 0.0)
    assert float(t[2].sum()) == 0.0
    tab = _rng().randint(0, 9, (5, 3)).astype(np.int32)
    (j, t), = run_both("gather", {"X": [tab], "Index": [np.array([4, 0, 4], np.int32)]})["Out"]
    assert_same(j, t, 0.0)
    (j, t), = run_both("multiplex", {"X": [tab, tab + 1], "Ids": [np.array([1, 0, 1, 1, 0],
                                                                           np.int32)]})["Out"]
    assert_same(j, t, 0.0)


# the op-level sweep: inputs beyond the layer cases' (ties, LoD inputs, attrs)
def _tied(shape, seed=0):
    """ReLU-like values with many zeros and repeats: tied maxima."""
    return np.maximum(np.round(_rng(seed).standard_normal(shape), 0), 0).astype(np.float32)


OPS = {
    "maxout_tied": ("maxout", {"X": [_tied((2, 6, 3, 3))]}, {"groups": 3}),
    "spp_tied": ("spp", {"X": [_tied((2, 3, 7, 6))]}, {"pyramid_height": 3}),
    "roi_pool_tied": ("roi_pool", {"X": [_tied((2, 3, 9, 11))], "ROIs": [np.array(
        [[0, 0, 0, 10, 8], [1, 3, 2, 9, 7], [1, 8, 6, 8, 6], [0, -4, 2, 30, 20],
         [1, 2, 2, 3, 3]], np.float32)]},
        {"pooled_height": 3, "pooled_width": 4, "spatial_scale": 1.0}),
    "roi_pool_scaled": ("roi_pool", {"X": [_x((2, 4, 8, 9))], "ROIs": [np.array(
        [[1, 0, 0, 130, 120], [0, 17, 31, 60, 50]], np.float32)]},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1 / 16}),
    "row_conv_dense": ("row_conv", {"X": [_x((2, 5, 3))], "Filter": [_x((3, 3), seed=1)]}, {}),
    "row_conv_lod": ("row_conv", {"X": [Lod([_x((n, 3), seed=n) for n in (4, 1, 3)])],
                                  "Filter": [_x((3, 3), seed=1)]}, {}),
    "dot_prod_lod": ("dot_prod", {"X": [Lod([_x((n, 3), seed=n) for n in (2, 3)])],
                                  "Y": [Lod([_x((n, 3), seed=n + 5) for n in (2, 3)])]}, {}),
    "prelu_channel_4d": ("prelu", {"X": [_x((2, 3, 2, 2))], "Alpha": [_x((3,), seed=1)]},
                         {"mode": "channel"}),
    "pad_3d": ("pad", {"X": [_x((2, 3, 4))]}, {"paddings": [0, 1, 2, 0, 1, 1],
                                               "pad_value": -1.5}),
    "conv3d_strided_grouped": ("conv3d", {"Input": [_x((2, 4, 5, 6, 5))],
                                          "Filter": [_x((6, 2, 3, 2, 3), seed=1)],
                                          "Bias": [_x((6,), seed=2)]},
                               {"strides": [2, 1, 2], "paddings": [1, 0, 1], "groups": 2}),
    "bilinear_interp_down": ("bilinear_interp", {"X": [_x((2, 3, 9, 7))]},
                             {"out_h": 4, "out_w": 1}),
    "sum_cost": ("sum_cost", {"X": [_x((4, 3))]}, {}),
    # integer labels tie in the ideal DCG's sort: the label's gradient
    # goes to the tied entries JAX's stable sort picks
    "lambda_cost_tied_labels": ("lambda_cost", {
        "Score": [_x((8, 16), 0.1, seed=3)],
        "Label": [_rng(3).randint(0, 4, (8, 16)).astype(np.float32)],
        "Mask": [(_rng(4).rand(8, 16) < 0.9).astype(np.float32)]}, {"NDCG_num": 5}),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_op_forward_and_gradient(case, one_thread):
    """Forward equal within 1e-5 of the output's scale; the gradient of
    Σ out·c (c a fixed draw) to every dense float input within 1e-5 of its
    scale, on tied inputs too: split among tied maxima as JAX splits it.
    The JAX side is one jitted function."""
    op, ins, attrs = OPS[case]
    slot = "Output" if op == "conv3d" else "Out"
    slots = [k for k, v in ins.items() if not isinstance(v[0], Lod)
             and np.issubdtype(v[0].dtype, np.floating) and k != "ROIs"]
    j, jg = _jax_op(op, ins, attrs, slots, slot)
    t, tg = _torch_op(op, ins, attrs, slots, slot)
    assert_same(j, t, TOL)
    for a, b in zip(jg, tg):
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL * scale)


def _cot(shape):
    return _x(tuple(shape), 1.0, seed=11)


def _jax_op(op, ins, attrs, slots, slot):
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp
    from test_torch_ops_general import _jval

    names = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in ins.items()}
    fixed = {n: _jval(v) for k, vals in ins.items() if k not in slots
             for n, v in zip(names[k], vals)}

    def run(*xs):
        env = dict(fixed, **{f"{k}_0": x for k, x in zip(slots, xs)})
        jreg.get_kernel(op)(jreg.OpContext(JOp(op, names, {slot: ["o"]}, dict(attrs)), env))
        return env["o"]

    def f(*xs):
        o, vjp = jax.vjp(run, *xs)
        data = o.data if hasattr(o, "seq_ids") else o
        cot = jnp.asarray(_cot(data.shape))
        return o, vjp(o.with_data(cot) if hasattr(o, "seq_ids") else cot)

    o, grads = jax.jit(f)(*[jnp.asarray(ins[k][0]) for k in slots])
    return o, [np.asarray(g) for g in grads]


def _torch_op(op, ins, attrs, slots, slot):
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator as TOp
    from test_torch_ops_general import _tval

    names = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in ins.items()}
    env = {}
    leaves = []
    for k, vals in ins.items():
        for n, v in zip(names[k], vals):
            env[n] = _tval(v)
            if k in slots:
                env[n] = env[n].clone().requires_grad_(True)
                leaves.append(env[n])
    treg.get_kernel(op)(treg.OpContext(TOp(op, names, {slot: ["o"]}, dict(attrs)), env))
    o = env["o"]
    data = o.data if hasattr(o, "seq_ids") else o
    if leaves:
        (data * torch.as_tensor(_cot(data.shape))).sum().backward()
    out = o.with_data(data.detach()) if hasattr(o, "seq_ids") else data.detach()
    return out, [leaf.grad.numpy() for leaf in leaves]


# ------------------------------------------------- checkpoints across -----
def _tree_costs(m, ckpt):
    """hsigmoid + nce over 7 classes (fixed negatives), SGD, through a
    Trainer checkpointing every 2 steps into `ckpt`."""
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    main, startup = m.Program(), m.Program()
    startup.random_seed = 3
    with m.program_guard(main, startup):
        x = m.layers.data("x", shape=[6])
        lbl = m.layers.data("lbl", shape=[1], dtype=np.int32)
        h = m.layers.fc(x, size=6, act="tanh")
        loss = m.layers.mean(m.layers.elementwise_add(
            m.layers.hsigmoid(h, lbl, num_classes=7),
            m.layers.nce(h, lbl, num_classes=7, num_neg_samples=3)))
        m.optimizer.SGD(learning_rate=0.5).minimize(loss)
    cfg = m.CheckpointConfig(ckpt, step_interval=2, max_num_checkpoints=10)
    kw = {} if m is pt else {"place": "cpu", "scope": ptt.Scope()}
    tr = m.Trainer(loss, main_program=main, startup_program=startup, checkpoint_config=cfg, **kw)
    return tr, [x, lbl]


def _tree_batches():
    rng = _rng(9)
    return [[(rng.randn(6).astype(np.float32), np.int32([rng.randint(0, 7)]))
             for _ in range(4)] for _ in range(3)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tree_cost_checkpoint_resumes_across(tmp_path, writer, fixed_draws, one_thread):
    """A Trainer checkpoint of an hsigmoid + nce program, taken at step 2 by
    one package, resumes in the other: the same parameter names, and the
    next step's cost within 1e-5 of the writer's own."""
    from test_torch_trainer import _keep_upto

    pkgs = {"port": ptt, "jax": pt}
    reader_pkg = pkgs["jax" if writer == "port" else "port"]
    d = str(tmp_path / "ck")
    tr, feeds = _tree_costs(pkgs[writer], d)
    costs = []
    tr.train(lambda: iter(_tree_batches()), 1, feed_order=feeds, log_interval=1,
             event_handler=lambda e: costs.append(float(e.cost)) if type(e).__name__ ==
             "EndIteration" else None)
    serial = _mid_pass_serial(d)
    r = str(tmp_path / "resume")
    _keep_upto(d, r, serial)
    tr2, feeds2 = _tree_costs(reader_pkg, r)
    tr2.init()
    got = []
    tr2.train(lambda: iter(_tree_batches()), 1, feed_order=feeds2, log_interval=1,
              event_handler=lambda e: got.append(float(e.cost)) if type(e).__name__ ==
              "EndIteration" else None)
    assert len(costs) == 3 and len(got) == 1
    assert abs(got[0] - costs[2]) <= 1e-5 * max(1.0, abs(costs[2]))


def _mid_pass_serial(d):
    """The serial written mid-way through pass 0, at step 2."""
    import json

    from paddle_tpu_torch import io as tio

    for s in tio._complete_serials(d):
        with open(os.path.join(tio._serial_dir(d, s), tio.META_FILE)) as f:
            args = json.load(f)["trainer_args"]
        if args.get("mid_pass") and args["pass_id"] == 0:
            assert args["step"] == 2
            return s
    raise AssertionError("no mid-pass checkpoint in pass 0")
