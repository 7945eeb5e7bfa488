"""Cost op kernels (paddle_tpu/ops/cost_ops.py), every op of that module:
the reference's cost layers beyond nn_ops.py's (CostLayer.cpp), NCE
(NCELayer.cpp) and the hierarchical sigmoid
(HierarchicalSigmoidLayer.cpp), on torch tensors; gradients by autograd.

`nce` draws its negatives from the run's generator (`draw_negatives`), so
it runs once a step (`runs_once`). Its and `hsigmoid`'s row gathers go
through `F.embedding`, whose backward sorts the ids and adds without
atomics: a step's bits do not change from run to run. `hsigmoid`'s path
tables are built once per class count on the host and held on each device
once (`hsigmoid_tables`), as the JAX op caches them.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.lod import LoDArray
from ..core.registry import register_op


def _data(x):
    return x.data if isinstance(x, LoDArray) else x


def softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_ce_logits_kernel(ctx):
    """softplus(x) - label·x: BCE on logits, stable at any x."""
    x = _data(ctx.input("X"))
    label = _data(ctx.input("Label")).to(x.dtype)
    ctx.set_output("Out", softplus(x) - label * x)


@register_op("binary_cross_entropy")
def binary_ce_kernel(ctx):
    """BCE on probabilities clipped to [1e-7, 1 - 1e-7] (the reference's
    soft_binary_class_cross_entropy, and multi_binary_label_cross_entropy
    with multi-hot labels)."""
    p = _data(ctx.input("X")).clamp(1e-7, 1.0 - 1e-7)
    label = _data(ctx.input("Label")).to(p.dtype)
    ctx.set_output("Out", -(label * torch.log(p) + (1.0 - label) * torch.log1p(-p)))


@register_op("cross_entropy_with_selfnorm")
def ce_selfnorm_kernel(ctx):
    """CE on an unnormalized softmax, plus alpha·log(Z)² (CostLayer.cpp:105)."""
    x = _data(ctx.input("X"))
    label = _data(ctx.input("Label")).reshape(-1).long()
    alpha = ctx.attr("softmax_selfnorm_alpha", 0.1)
    z = x.sum(-1)
    p = x.gather(-1, label[:, None])[:, 0] / z
    out = -torch.log(p.clamp(min=1e-20)) + alpha * torch.square(torch.log(z))
    ctx.set_output("Out", out[:, None])


@register_op("smooth_l1")
def smooth_l1_kernel(ctx):
    """0.5·d²·σ² where |d| < 1/σ², else |d| - 0.5/σ², with the optional
    inside and outside weights; summed over the last axis."""
    x = _data(ctx.input("X"))
    d = x - _data(ctx.input("Y"))
    sigma = ctx.attr("sigma", 1.0)
    if ctx.has_input("InsideWeight"):
        d = d * _data(ctx.input("InsideWeight"))
    a = d.abs()
    s2 = sigma * sigma
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        loss = loss * _data(ctx.input("OutsideWeight"))
    ctx.set_output("Out", loss.sum(-1, keepdim=True))


@register_op("rank_cost")
def rank_cost_kernel(ctx):
    """Pairwise logistic loss on o = left - right: softplus(o) - label·o."""
    left = _data(ctx.input("Left")).reshape(-1)
    right = _data(ctx.input("Right")).reshape(-1)
    label = _data(ctx.input("Label")).reshape(-1).to(left.dtype)
    o = left - right
    ctx.set_output("Out", (softplus(o) - label * o)[:, None])


@register_op("margin_rank_loss")
def margin_rank_loss_kernel(ctx):
    """max(0, -label·(x1 - x2) + margin)."""
    x1 = _data(ctx.input("X1")).reshape(-1)
    x2 = _data(ctx.input("X2")).reshape(-1)
    label = _data(ctx.input("Label")).reshape(-1).to(x1.dtype)
    out = (-label * (x1 - x2) + ctx.attr("margin", 0.0)).clamp(min=0.0)
    ctx.set_output("Out", out[:, None])


@register_op("huber_classification")
def huber_classification_kernel(ctx):
    """HuberTwoClassification (CostLayer.cpp:663): y = 2·label - 1, a = y·x;
    -4a below -1, (1 - a)² up to 1, 0 above."""
    x = _data(ctx.input("X")).reshape(-1)
    a = (2.0 * _data(ctx.input("Label")).reshape(-1).to(x.dtype) - 1.0) * x
    out = torch.where(a < -1.0, -4.0 * a,
                      torch.where(a < 1.0, torch.square(1.0 - a), torch.zeros_like(a)))
    ctx.set_output("Out", out[:, None])


@register_op("sum_cost")
def sum_cost_kernel(ctx):
    ctx.set_output("Out", _data(ctx.input("X")).sum())


@register_op("lambda_cost")
def lambda_cost_kernel(ctx):
    """The JAX op's smooth listwise surrogate of LambdaCost
    (CostLayer.cpp:347): -NDCG@NDCG_num of each padded list, Score, Label
    and Mask [L, S], with soft ranks r_i = 1 + Σ_j σ(10(s_j - s_i)) - ½ over
    real entries and a sigmoid truncation at NDCG_num; the ideal DCG from
    the hard-sorted gains."""
    score = _data(ctx.input("Score"))
    label = _data(ctx.input("Label")).to(score.dtype)
    mask = _data(ctx.input("Mask")) if ctx.has_input("Mask") else torch.ones_like(score)
    ndcg_num = ctx.attr("NDCG_num", 5)
    diff = (score[:, None, :] - score[:, :, None]) * 10.0
    soft_gt = torch.sigmoid(diff) * mask[:, None, :]
    soft_rank = 1.0 + soft_gt.sum(-1) - 0.5
    gain = (torch.exp2(label) - 1.0) * mask
    disc = 1.0 / torch.log2(1.0 + soft_rank)
    trunc = torch.sigmoid((ndcg_num - soft_rank + 0.5) * 10.0)
    dcg = (gain * disc * trunc).sum(-1)
    # ascending and stable, then reversed, as jnp.sort(...)[:, ::-1]: tied
    # gains hand their gradient to the same entries as in JAX
    sorted_gain = torch.sort(gain, dim=-1, stable=True).values.flip(-1)
    pos = torch.arange(score.shape[1], dtype=score.dtype, device=score.device)
    ideal_disc = torch.where(pos < ndcg_num, 1.0 / torch.log2(2.0 + pos),
                             torch.zeros_like(pos))
    idcg = (sorted_gain * ideal_disc[None, :]).sum(-1)
    ctx.set_output("Out", -(dcg / idcg.clamp(min=1e-12))[:, None])


# ------------------------------------------------------------ sampled/tree --
def draw_negatives(gen, n: int, num_neg: int, num_classes: int):
    """nce's [n, num_neg] uniform negative classes, from the run's generator."""
    return torch.randint(0, num_classes, (n, num_neg), generator=gen, device=gen.device)


def nce_loss(x, w, label, neg, bias=None):
    """NCE with uniform noise on given negatives: per row, BCE on logits of
    the true class (target 1) and the negatives (target 0), each logit
    shifted by log(k·q) = log(num_neg / num_classes). [N, 1]."""
    num_neg, num_classes = neg.shape[1], w.shape[0]
    log_kq = float(np.log(np.float32(num_neg / num_classes)))

    def logit(ids):  # [N, K] -> [N, K]
        s = torch.einsum("nd,nkd->nk", x, F.embedding(ids, w))
        if bias is not None:
            s = s + F.embedding(ids, bias.reshape(-1, 1))[..., 0]
        return s - log_kq

    loss = softplus(-logit(label[:, None]))[:, 0] + softplus(logit(neg)).sum(-1)
    return loss[:, None]


@register_op("nce", runs_once=True)
def nce_kernel(ctx):
    """NCELayer.cpp / nce_op.cc: noise-contrastive estimation, Input [N, D],
    Weight [C, D], its negatives drawn uniformly each step."""
    x = _data(ctx.input("Input"))
    w = _data(ctx.input("Weight"))
    label = _data(ctx.input("Label")).reshape(-1).long()
    neg = draw_negatives(ctx.generator(), x.shape[0], ctx.attr("num_neg_samples", 10),
                         w.shape[0])
    bias = _data(ctx.input("Bias")) if ctx.has_input("Bias") else None
    ctx.set_output("Cost", nce_loss(x, w, label, neg, bias))


@functools.lru_cache(maxsize=None)
def _hsigmoid_tables_np(num_classes: int):
    """(nodes, bits, valid) [num_classes, depth] of the complete binary tree
    in heap layout: class c's leaf code is c + num_classes, its ancestors
    code >> t, node row code - 1 (the reference's SimpleCode)."""
    max_depth = int(np.floor(np.log2(2 * num_classes - 1)))
    nodes = np.zeros((num_classes, max_depth), np.int64)
    bits = np.zeros((num_classes, max_depth), np.float32)
    valid = np.zeros((num_classes, max_depth), np.float32)
    for c in range(num_classes):
        code = c + num_classes
        depth = code.bit_length() - 1
        for j in range(depth):
            nodes[c, j] = (code >> (depth - j)) - 1
            bits[c, j] = (code >> (depth - 1 - j)) & 1
            valid[c, j] = 1.0
    return nodes, bits, valid


_TABLES: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, ...]] = {}


def hsigmoid_tables(num_classes: int, device) -> Tuple[torch.Tensor, ...]:
    """The path tables of `num_classes` on `device`, copied there once."""
    key = (int(num_classes), torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.as_tensor(a, device=device)
                             for a in _hsigmoid_tables_np(int(num_classes)))
    return _TABLES[key]


@register_op("hsigmoid")
def hsigmoid_kernel(ctx):
    """Binary-tree factorized softmax: the sum of BCE-with-logits along the
    label's root-to-leaf path, one weight row an internal node. [N, 1]."""
    x = _data(ctx.input("X"))
    w = _data(ctx.input("W"))
    label = _data(ctx.input("Label")).reshape(-1).long()
    nodes_t, bits_t, valid_t = hsigmoid_tables(ctx.attr("num_classes"), x.device)
    nodes, bits, valid = nodes_t[label], bits_t[label], valid_t[label]
    s = torch.einsum("nd,njd->nj", x, F.embedding(nodes, w))
    if ctx.has_input("Bias"):
        s = s + F.embedding(nodes, _data(ctx.input("Bias")).reshape(-1, 1))[..., 0]
    loss = (softplus(s) - bits * s) * valid
    ctx.set_output("Cost", loss.sum(-1, keepdim=True))
