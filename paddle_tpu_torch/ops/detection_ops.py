"""SSD detection ops (paddle_tpu/ops/detection_ops.py): prior boxes,
the multibox loss and the detection output, on torch tensors.

Ground truth is padded dense: GtBox [N, G, 4], GtLabel [N, G] with label
0 the background and the padding. Boxes are corners (xmin, ymin, xmax,
ymax) normalized to [0, 1], encoded by SSD's center-variance scheme
(DetectionUtil.cpp).

`detection_output` runs the JAX op's greedy NMS, a fixed number of
iterations of one class's scan, once over every image and non-background
class together: the rows of one [N, C-1, K] score tensor, each iteration
a few ops on all of them, with nothing read on the host. Sorts are stable
and argmaxes take the first of equal values, as `jnp.argsort` and
`jnp.argmax` do.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..core.lod import LoDArray
from ..core.registry import register_op


def _data(x):
    return x.data if isinstance(x, LoDArray) else x


def _corner_to_center(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h, w, h


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)


def iou_matrix(a, b, area_b=None):
    """Pairwise IoU: a [..., A, 4], b [..., B, 4] -> [..., A, B]; `area_b`,
    when given, is b's areas (the same values, computed once)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_b = _area(b) if area_b is None else area_b
    union = _area(a)[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def encode_boxes(gt, priors, variances):
    """SSD center-variance encoding (DetectionUtil.cpp encodeBBox)."""
    gcx, gcy, gw, gh = _corner_to_center(gt)
    pcx, pcy, pw, ph = _corner_to_center(priors)
    tx = (gcx - pcx) / (pw * variances[..., 0])
    ty = (gcy - pcy) / (ph * variances[..., 1])
    tw = torch.log((gw / pw.clamp(min=1e-10)).clamp(min=1e-10)) / variances[..., 2]
    th = torch.log((gh / ph.clamp(min=1e-10)).clamp(min=1e-10)) / variances[..., 3]
    return torch.stack([tx, ty, tw, th], -1)


def decode_boxes(loc, priors, variances):
    """encode_boxes' inverse (DetectionUtil.cpp decodeBBox)."""
    pcx, pcy, pw, ph = _corner_to_center(priors)
    cx = pcx + loc[..., 0] * variances[..., 0] * pw
    cy = pcy + loc[..., 1] * variances[..., 1] * ph
    w = pw * torch.exp(loc[..., 2] * variances[..., 2])
    h = ph * torch.exp(loc[..., 3] * variances[..., 3])
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def make_prior_boxes(layer_h, layer_w, image_h, image_w, min_sizes, max_sizes,
                     aspect_ratios, variance, clip=True):
    """The numpy prior table of one feature map, (boxes [K, 4], variances
    [K, 4]): PriorBox.cpp's loop nest, with each aspect ratio's flip 1/ar
    and the sqrt(min·max) square prior of each (min, max) pair."""
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError(
            f"max_sizes ({len(max_sizes)}) must match min_sizes "
            f"({len(min_sizes)}) — PriorBox.cpp pairs them elementwise")
    ars = [1.0]
    for ar in aspect_ratios:
        if abs(ar - 1.0) < 1e-6:
            continue
        ars.extend([ar, 1.0 / ar])
    step_w = image_w / layer_w
    step_h = image_h / layer_h
    boxes = []
    for hh in range(layer_h):
        for ww in range(layer_w):
            cx = (ww + 0.5) * step_w
            cy = (hh + 0.5) * step_h
            for s, mn in enumerate(min_sizes):
                for ar in ars:
                    bw = mn * math.sqrt(ar)
                    bh = mn / math.sqrt(ar)
                    boxes.append([(cx - bw / 2) / image_w, (cy - bh / 2) / image_h,
                                  (cx + bw / 2) / image_w, (cy + bh / 2) / image_h])
                if max_sizes:
                    sz = math.sqrt(mn * max_sizes[s])
                    boxes.append([(cx - sz / 2) / image_w, (cy - sz / 2) / image_h,
                                  (cx + sz / 2) / image_w, (cy + sz / 2) / image_h])
    out = np.asarray(boxes, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.asarray(variance, np.float32)[None, :], (out.shape[0], 1))
    return out, var


_PRIORS: Dict[tuple, tuple] = {}


@register_op("prior_box")
def prior_box_kernel(ctx):
    """The prior table of the Input map's size within the Image's: made on
    the host once per configuration and device, then reused."""
    x, img = _data(ctx.input("Input")), _data(ctx.input("Image"))
    args = (x.shape[2], x.shape[3], img.shape[2], img.shape[3],
            tuple(ctx.attr("min_sizes")), tuple(ctx.attr("max_sizes") or ()),
            tuple(ctx.attr("aspect_ratios")), tuple(ctx.attr("variances")),
            bool(ctx.attr("clip", True)))
    key = args + (x.device,)
    if key not in _PRIORS:
        boxes, var = make_prior_boxes(*args[:4], *(list(a) for a in args[4:8]), args[8])
        _PRIORS[key] = (torch.as_tensor(boxes, device=x.device),
                        torch.as_tensor(var, device=x.device))
    boxes, var = _PRIORS[key]
    ctx.set_output("Boxes", boxes)
    ctx.set_output("Variances", var)


@register_op("multibox_loss")
def multibox_loss_kernel(ctx):
    """MultiBoxLossLayer.cpp on padded-dense inputs: Loc [N, K, 4] or
    [N, K·4], Conf [N, K, C] or [N, K·C], Priors and PriorVar [K, 4].
    Each prior matches its highest-IoU ground truth (the first of equal
    IoUs) and is positive above overlap_threshold; smooth L1 on the
    positives' offsets, softmax CE on the positives and on the hardest
    negatives, neg_pos_ratio of them an image (ranked by a stable sort);
    the sum over the positives' count. Out [N, 1]."""
    loc, conf = _data(ctx.input("Loc")), _data(ctx.input("Conf"))
    priors, pvar = _data(ctx.input("Priors")), _data(ctx.input("PriorVar"))
    gt = _data(ctx.input("GtBox"))
    gtl = _data(ctx.input("GtLabel")).long()
    thresh = ctx.attr("overlap_threshold", 0.5)
    neg_ratio = ctx.attr("neg_pos_ratio", 3.0)
    n, k = gt.shape[0], priors.shape[0]
    loc = loc.reshape(n, k, 4)
    c = conf.shape[-1] if conf.dim() == 3 else conf.shape[1] // k
    conf = conf.reshape(n, k, c)

    gt_valid = (gtl > 0).to(torch.float32)
    iou = iou_matrix(priors.expand(n, k, 4), gt) * gt_valid[:, None, :]  # [N, K, G]
    best_iou = iou.amax(-1)
    best_gt = iou.argmax(-1)  # the first of equal IoUs, as jnp.argmax
    pos = (best_iou > thresh).to(torch.float32)
    matched_box = gt.gather(1, best_gt[..., None].expand(n, k, 4))
    matched_lbl = gtl.gather(1, best_gt)

    d = loc - encode_boxes(matched_box, priors[None], pvar[None])
    a = d.abs()
    loc_loss = (torch.where(a < 1.0, 0.5 * d * d, a - 0.5).sum(-1) * pos).sum(-1)

    tgt = torch.where(pos > 0, matched_lbl, torch.zeros_like(matched_lbl))
    ce = -torch.log_softmax(conf, -1).gather(-1, tgt[..., None])[..., 0]  # [N, K]

    num_pos = pos.sum(-1)
    num_neg = torch.clamp(neg_ratio * num_pos, max=float(k))
    neg_ce = torch.where(pos > 0, torch.full_like(ce, float("-inf")), ce).detach()
    order = torch.argsort(-neg_ce, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(k, device=order.device).expand(n, k))
    neg_sel = (rank.to(torch.float32) < num_neg[:, None]).to(torch.float32) * (1.0 - pos)
    conf_loss = (ce * (pos + neg_sel)).sum(-1)
    ctx.set_output("Out", ((loc_loss + conf_loss) / num_pos.clamp(min=1.0))[:, None])


def batched_nms(boxes, scores, iterations: int, nms_threshold: float):
    """Greedy NMS over many rows at once, `iterations` steps: boxes
    [N, K, 4], scores [N, R, K] (each image's R rows share its boxes). Each
    step takes every row's best live box and kills the boxes overlapping it
    above the threshold. Returns (indices [N, R, iterations], valid: the
    taken score > 0)."""
    n, r, k = scores.shape
    area = _area(boxes)[:, None, :]  # [N, 1, K]
    rows = boxes[:, None].expand(n, r, k, 4)
    alive = scores
    idx, valid = [], []
    for _ in range(iterations):
        i = alive.argmax(-1, keepdim=True)  # [N, R, 1]
        best = alive.gather(-1, i)
        picked = rows.gather(2, i[..., None].expand(n, r, 1, 4))  # [N, R, 1, 4]
        ious = iou_matrix(picked, boxes[:, None], area)[..., 0, :]  # [N, R, K]
        alive = torch.where(ious > nms_threshold, torch.zeros_like(alive), alive)
        alive = alive.scatter(-1, i, 0.0)
        idx.append(i)
        valid.append(best > 0.0)
    return torch.cat(idx, -1), torch.cat(valid, -1)


@register_op("detection_output")
def detection_output_kernel(ctx):
    """DetectionOutputLayer.cpp: decode, per-class greedy NMS, keep_top_k.
    Out [N, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), the empty
    ones -1 (the reference's ragged result, padded)."""
    loc, conf = _data(ctx.input("Loc")), _data(ctx.input("Conf"))
    priors, pvar = _data(ctx.input("Priors")), _data(ctx.input("PriorVar"))
    conf_thresh = ctx.attr("confidence_threshold", 0.01)
    keep_top_k = ctx.attr("keep_top_k", 200)
    bg = ctx.attr("background_id", 0)
    n, k = conf.shape[0], priors.shape[0]
    c = conf.shape[-1] if conf.dim() == 3 else conf.shape[1] // k
    probs = torch.softmax(conf.reshape(n, k, c), -1)
    decoded = decode_boxes(loc.reshape(n, k, 4), priors[None], pvar[None])  # [N, K, 4]
    every = torch.arange(c, device=probs.device)
    cls_t = torch.cat([every[:bg], every[bg + 1:]])  # the non-background classes
    pc = probs.transpose(1, 2)[:, cls_t]  # [N, C-1, K]
    scores = torch.where(pc > conf_thresh, pc, torch.zeros_like(pc))
    per_class = min(ctx.attr("nms_top_k", 400), k)
    idx, valid = batched_nms(decoded, scores, per_class, ctx.attr("nms_threshold", 0.45))
    sel_scores = pc.gather(-1, idx) * valid  # [N, C-1, P]
    sel_boxes = decoded.gather(1, idx.reshape(n, -1, 1).expand(n, idx[0].numel(), 4))
    lab = torch.where(valid, cls_t[None, :, None].to(probs.dtype),
                      torch.full_like(sel_scores, -1.0))
    rows = torch.cat([lab.reshape(n, -1, 1), sel_scores.reshape(n, -1, 1), sel_boxes], -1)
    order = torch.argsort(-rows[..., 1], dim=-1, stable=True)[:, :keep_top_k]
    top = rows.gather(1, order[..., None].expand(n, order.shape[1], 6))
    if top.shape[1] < keep_top_k:
        top = torch.cat([top, top.new_full((n, keep_top_k - top.shape[1], 6), -1.0)], 1)
    ctx.set_output("Out", torch.where(top[..., 1:2] > 0, top, torch.full_like(top, -1.0)))
