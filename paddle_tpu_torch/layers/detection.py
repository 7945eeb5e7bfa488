"""SSD detection layers (paddle_tpu/layers/detection.py): `prior_box`,
`multibox_loss`, `detection_output` and `num_priors`, the priors a map
location (ops/detection_ops.py). Ground truth is padded dense, label 0
the background and the padding."""

from __future__ import annotations

import numpy as np

from .helper import LayerHelper

__all__ = ["prior_box", "multibox_loss", "detection_output", "num_priors"]


def num_priors(min_sizes, max_sizes, aspect_ratios):
    """Priors per spatial location (PriorBox.cpp init: ars incl. flip + 1).
    max_sizes, when given, must pair 1:1 with min_sizes (CHECK_EQ in the
    reference) — one extra sqrt(min*max) square prior per pair."""
    max_sizes = max_sizes or []
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError("max_sizes must be empty or match min_sizes 1:1")
    n_ar = 1 + 2 * len([a for a in aspect_ratios if abs(a - 1.0) >= 1e-6])
    return n_ar * len(min_sizes) + len(max_sizes)


def prior_box(input, image, min_sizes, aspect_ratios, variances,
              max_sizes=None, clip=True):
    helper = LayerHelper("prior_box")
    k = input.shape[2] * input.shape[3] * num_priors(
        min_sizes, max_sizes or [], aspect_ratios
    )
    boxes = helper.create_tmp_variable(np.float32, (k, 4))
    var = helper.create_tmp_variable(np.float32, (k, 4))
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"min_sizes": list(min_sizes), "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variances), "clip": clip},
    )
    return boxes, var


def multibox_loss(loc, conf, priors, prior_var, gt_box, gt_label,
                  overlap_threshold=0.5, neg_pos_ratio=3.0):
    helper = LayerHelper("multibox_loss")
    n = gt_box.shape[0]
    out = helper.create_tmp_variable(np.float32, (n, 1))
    helper.append_op(
        type="multibox_loss",
        inputs={"Loc": [loc], "Conf": [conf], "Priors": [priors],
                "PriorVar": [prior_var], "GtBox": [gt_box],
                "GtLabel": [gt_label]},
        outputs={"Out": [out]},
        attrs={"overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio},
    )
    return out


def detection_output(loc, conf, priors, prior_var, confidence_threshold=0.01,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     background_id=0):
    helper = LayerHelper("detection_output")
    n = loc.shape[0]
    out = helper.create_tmp_variable(np.float32, (n, keep_top_k, 6))
    helper.append_op(
        type="detection_output",
        inputs={"Loc": [loc], "Conf": [conf], "Priors": [priors],
                "PriorVar": [prior_var]},
        outputs={"Out": [out]},
        attrs={"confidence_threshold": confidence_threshold,
               "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "background_id": background_id},
    )
    return out
