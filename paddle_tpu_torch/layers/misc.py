"""Tensor-manipulation and cost layers (paddle_tpu/layers/misc.py), every
name of that module: gather, scatter and the shape transforms, the
reference's elementwise and row layers, row_conv, the factored layers,
3-D conv and pooling, ROI and pyramid pooling, the cost layers beyond
nn.py's, NCE and the hierarchical sigmoid. Shapes, attrs and parameter
names are the JAX front end's, so a program built here serializes to its
dict and a checkpoint crosses between the packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.program import Variable
from ..initializer import ConstantInitializer
from .helper import LayerHelper

__all__ = [
    "gather",
    "scatter",
    "one_hot",
    "pad",
    "crop",
    "multiplex",
    "maxout",
    "prelu",
    "cos_sim",
    "dot_prod",
    "out_prod",
    "l2_distance",
    "row_l2_norm",
    "l2_normalize",
    "interpolation",
    "power",
    "scaling",
    "slope_intercept",
    "sum_to_one_norm",
    "convex_comb",
    "scale_shift",
    "scale_sub_region",
    "rotate",
    "switch_order",
    "bilinear_interp",
    "im2sequence",
    "row_conv",
    "conv_shift",
    "sampling_id",
    "factorization_machine",
    "bilinear_tensor_product",
    "selective_fc",
    "conv3d",
    "pool3d",
    "roi_pool",
    "spp",
    "sigmoid_cross_entropy_with_logits",
    "binary_cross_entropy",
    "cross_entropy_with_selfnorm",
    "smooth_l1",
    "rank_cost",
    "margin_rank_loss",
    "huber_regression_cost",
    "huber_classification_cost",
    "sum_cost",
    "lambda_cost",
    "nce",
    "hsigmoid",
]


def _simple(op_type, inputs, out_shape, dtype=np.float32, attrs=None,
            out_slot="Out", lod_level=0, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_tmp_variable(dtype, tuple(out_shape), lod_level=lod_level)
    helper.append_op(type=op_type, inputs=inputs, outputs={out_slot: [out]},
                     attrs=attrs or {})
    return out


# ------------------------------------------------------- gather / scatter ---
def gather(x, index):
    n = index.shape[0] if index.shape else 0
    return _simple("gather", {"X": [x], "Index": [index]},
                   (n,) + tuple(x.shape[1:]), x.dtype)


def scatter(x, index, updates, overwrite=True):
    return _simple("scatter", {"X": [x], "Index": [index], "Updates": [updates]},
                   x.shape, x.dtype, {"overwrite": overwrite})


def one_hot(x, depth):
    n = int(np.prod(x.shape)) if x.shape else 0
    return _simple("one_hot", {"X": [x]}, (n, depth), np.float32,
                   {"depth": depth})


# ------------------------------------------------------------- pad / crop ---
def pad(x, paddings, pad_value=0.0):
    shape = tuple(
        s + paddings[2 * i] + paddings[2 * i + 1] for i, s in enumerate(x.shape)
    )
    return _simple("pad", {"X": [x]}, shape, x.dtype,
                   {"paddings": list(paddings), "pad_value": pad_value})


def crop(x, offsets, shape):
    return _simple("crop", {"X": [x]}, tuple(shape), x.dtype,
                   {"offsets": list(offsets), "shape": list(shape)})


def multiplex(inputs: Sequence[Variable], ids):
    return _simple("multiplex", {"X": list(inputs), "Ids": [ids]},
                   inputs[0].shape, inputs[0].dtype)


# -------------------------------------------------------------- transforms --
def maxout(x, groups):
    n, c, h, w = x.shape
    return _simple("maxout", {"X": [x]}, (n, c // groups, h, w), x.dtype,
                   {"groups": groups})


def prelu(x, mode="all", param_attr=None):
    helper = LayerHelper("prelu")
    if mode == "all":
        alpha_shape = (1,)
    elif mode == "channel":
        alpha_shape = (x.shape[1],)
    else:  # element
        alpha_shape = tuple(x.shape[1:])
    alpha = helper.create_parameter(param_attr, alpha_shape,
                                    default_initializer=ConstantInitializer(0.25))
    out = helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def cos_sim(x, y, scale=1.0):
    return _simple("cos_sim", {"X": [x], "Y": [y]}, (x.shape[0], 1), x.dtype,
                   {"scale": scale}, lod_level=x.lod_level)


def dot_prod(x, y):
    return _simple("dot_prod", {"X": [x], "Y": [y]}, (x.shape[0], 1), x.dtype)


def out_prod(x, y):
    return _simple("out_prod", {"X": [x], "Y": [y]},
                   (x.shape[0], x.shape[1] * y.shape[1]), x.dtype)


def l2_distance(x, y):
    return _simple("l2_distance", {"X": [x], "Y": [y]}, (x.shape[0], 1), x.dtype)


def row_l2_norm(x):
    return _simple("row_l2_norm", {"X": [x]}, x.shape, x.dtype)


l2_normalize = row_l2_norm


def interpolation(x, y, w):
    return _simple("interpolation", {"X": [x], "Y": [y], "W": [w]},
                   x.shape, x.dtype)


def power(x, w):
    return _simple("power", {"X": [x], "W": [w]}, x.shape, x.dtype)


def scaling(x, w):
    return _simple("scaling", {"X": [x], "W": [w]}, x.shape, x.dtype)


def slope_intercept(x, slope=1.0, intercept=0.0):
    return _simple("slope_intercept", {"X": [x]}, x.shape, x.dtype,
                   {"slope": slope, "intercept": intercept})


def sum_to_one_norm(x):
    return _simple("sum_to_one_norm", {"X": [x]}, x.shape, x.dtype)


def convex_comb(x, weights):
    n, k = weights.shape
    return _simple("convex_comb", {"X": [x], "W": [weights]},
                   (n, x.shape[1] // k), x.dtype)


def scale_shift(x, param_attr=None, bias_attr=None):
    helper = LayerHelper("scale_shift")
    scale = helper.create_parameter(param_attr, (1,),
                                    default_initializer=ConstantInitializer(1.0))
    inputs = {"X": [x], "Scale": [scale]}
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, (1,), is_bias=True)
        inputs["Bias"] = [bias]
    out = helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(type="scale_shift", inputs=inputs, outputs={"Out": [out]})
    return out


def scale_sub_region(x, indices, scale=1.0):
    return _simple("scale_sub_region", {"X": [x]}, x.shape, x.dtype,
                   {"indices": list(indices), "scale": scale})


def rotate(x):
    n, c, h, w = x.shape
    return _simple("rotate", {"X": [x]}, (n, c, w, h), x.dtype)


def switch_order(x):
    n, c, h, w = x.shape
    return _simple("switch_order", {"X": [x]}, (n, h, w, c), x.dtype)


def bilinear_interp(x, out_h, out_w):
    n, c = x.shape[:2]
    return _simple("bilinear_interp", {"X": [x]}, (n, c, out_h, out_w), x.dtype,
                   {"out_h": out_h, "out_w": out_w})


def im2sequence(x, block_y, block_x, stride_y=1, stride_x=1, padding_y=0,
                padding_x=0):
    n, c, h, w = x.shape
    oh = (h + 2 * padding_y - block_y) // stride_y + 1
    ow = (w + 2 * padding_x - block_x) // stride_x + 1
    return _simple(
        "im2sequence", {"X": [x]}, (n, oh * ow, c * block_y * block_x), x.dtype,
        {"block_y": block_y, "block_x": block_x, "stride_y": stride_y,
         "stride_x": stride_x, "padding_y": padding_y, "padding_x": padding_x})


def row_conv(x, future_context_size, param_attr=None):
    helper = LayerHelper("row_conv")
    d = x.shape[-1]
    w = helper.create_parameter(param_attr, (future_context_size + 1, d))
    out = helper.create_tmp_variable(x.dtype, x.shape, lod_level=x.lod_level)
    helper.append_op(type="row_conv", inputs={"X": [x], "Filter": [w]},
                     outputs={"Out": [out]})
    return out


def conv_shift(x, y):
    return _simple("conv_shift", {"X": [x], "Y": [y]}, x.shape, x.dtype)


def sampling_id(x):
    return _simple("sampling_id", {"X": [x]}, (x.shape[0],), np.int32)


def factorization_machine(x, factor_size, param_attr=None):
    helper = LayerHelper("factorization_machine")
    v = helper.create_parameter(param_attr, (x.shape[-1], factor_size))
    out = helper.create_tmp_variable(x.dtype, (x.shape[0], 1))
    helper.append_op(type="factorization_machine",
                     inputs={"X": [x], "Factor": [v]}, outputs={"Out": [out]})
    return out


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product")
    w = helper.create_parameter(param_attr, (size, x.shape[-1], y.shape[-1]))
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, (size,), is_bias=True)
        inputs["Bias"] = [bias]
    out = helper.create_tmp_variable(x.dtype, (x.shape[0], size))
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return out


def selective_fc(x, size, mask=None, param_attr=None, bias_attr=None):
    helper = LayerHelper("selective_fc")
    w = helper.create_parameter(param_attr, (x.shape[-1], size))
    inputs = {"X": [x], "W": [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, (size,), is_bias=True)
        inputs["Bias"] = [bias]
    if mask is not None:
        inputs["Mask"] = [mask]
    out = helper.create_tmp_variable(x.dtype, (x.shape[0], size))
    helper.append_op(type="selective_fc", inputs=inputs, outputs={"Out": [out]})
    return out


# ------------------------------------------------------------------ 3-D -----
def conv3d(input, num_filters, filter_size, stride=1, padding=0, groups=1,
           param_attr=None, bias_attr=None, act=None):
    helper = LayerHelper("conv3d")
    k = (filter_size,) * 3 if isinstance(filter_size, int) else tuple(filter_size)
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    p = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    n, c = input.shape[0], input.shape[1]
    w = helper.create_parameter(param_attr, (num_filters, c // groups) + k)
    inputs = {"Input": [input], "Filter": [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, (num_filters,), is_bias=True)
        inputs["Bias"] = [bias]
    spatial = tuple(
        (d + 2 * p[i] - k[i]) // s[i] + 1 for i, d in enumerate(input.shape[2:])
    )
    out = helper.create_tmp_variable(input.dtype, (n, num_filters) + spatial)
    helper.append_op(type="conv3d", inputs=inputs, outputs={"Output": [out]},
                     attrs={"strides": list(s), "paddings": list(p),
                            "groups": groups})
    return helper.append_activation(out, act)


def pool3d(input, pool_size, pool_type="max", pool_stride=None, pool_padding=0):
    k = (pool_size,) * 3 if isinstance(pool_size, int) else tuple(pool_size)
    s = k if pool_stride is None else (
        (pool_stride,) * 3 if isinstance(pool_stride, int) else tuple(pool_stride))
    p = (pool_padding,) * 3 if isinstance(pool_padding, int) else tuple(pool_padding)
    n, c = input.shape[0], input.shape[1]
    spatial = tuple(
        (d + 2 * p[i] - k[i]) // s[i] + 1 for i, d in enumerate(input.shape[2:])
    )
    return _simple("pool3d", {"X": [input]}, (n, c) + spatial, input.dtype,
                   {"pooling_type": pool_type, "ksize": list(k),
                    "strides": list(s), "paddings": list(p)})


def roi_pool(x, rois, pooled_height, pooled_width, spatial_scale=1.0):
    r = rois.shape[0]
    return _simple("roi_pool", {"X": [x], "ROIs": [rois]},
                   (r, x.shape[1], pooled_height, pooled_width), x.dtype,
                   {"pooled_height": pooled_height, "pooled_width": pooled_width,
                    "spatial_scale": spatial_scale})


def spp(x, pyramid_height=3, pool_type="max"):
    c = x.shape[1]
    total = sum(4**l for l in range(pyramid_height))
    return _simple("spp", {"X": [x]}, (x.shape[0], c * total), x.dtype,
                   {"pyramid_height": pyramid_height, "pooling_type": pool_type})


# ------------------------------------------------------------------ costs ---
def sigmoid_cross_entropy_with_logits(x, label):
    return _simple("sigmoid_cross_entropy_with_logits",
                   {"X": [x], "Label": [label]}, x.shape, x.dtype)


def binary_cross_entropy(x, label):
    return _simple("binary_cross_entropy", {"X": [x], "Label": [label]},
                   x.shape, x.dtype)


def cross_entropy_with_selfnorm(x, label, softmax_selfnorm_alpha=0.1):
    return _simple("cross_entropy_with_selfnorm", {"X": [x], "Label": [label]},
                   (x.shape[0], 1), x.dtype,
                   {"softmax_selfnorm_alpha": softmax_selfnorm_alpha})


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    return _simple("smooth_l1", inputs, (x.shape[0], 1), x.dtype,
                   {"sigma": sigma})


def rank_cost(left, right, label):
    return _simple("rank_cost", {"Left": [left], "Right": [right],
                                 "Label": [label]}, (left.shape[0], 1),
                   left.dtype)


def margin_rank_loss(x1, x2, label, margin=0.0):
    return _simple("margin_rank_loss", {"X1": [x1], "X2": [x2],
                                        "Label": [label]},
                   (x1.shape[0], 1), x1.dtype, {"margin": margin})


def huber_regression_cost(x, label, delta=1.0):
    return _simple("huber_loss", {"X": [x], "Y": [label]}, x.shape, x.dtype,
                   {"delta": delta})


def huber_classification_cost(x, label):
    return _simple("huber_classification", {"X": [x], "Label": [label]},
                   (x.shape[0], 1), x.dtype)


def sum_cost(x):
    return _simple("sum_cost", {"X": [x]}, (), x.dtype)


def lambda_cost(score, label, mask=None, NDCG_num=5):
    inputs = {"Score": [score], "Label": [label]}
    if mask is not None:
        inputs["Mask"] = [mask]
    return _simple("lambda_cost", inputs, (score.shape[0], 1), score.dtype,
                   {"NDCG_num": NDCG_num})


def nce(input, label, num_classes, num_neg_samples=10, param_attr=None,
        bias_attr=None):
    helper = LayerHelper("nce")
    w = helper.create_parameter(param_attr, (num_classes, input.shape[-1]))
    inputs = {"Input": [input], "Weight": [w], "Label": [label]}
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, (num_classes,), is_bias=True)
        inputs["Bias"] = [bias]
    out = helper.create_tmp_variable(input.dtype, (input.shape[0], 1))
    helper.append_op(type="nce", inputs=inputs, outputs={"Cost": [out]},
                     attrs={"num_neg_samples": num_neg_samples})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None):
    helper = LayerHelper("hsigmoid")
    w = helper.create_parameter(param_attr, (num_classes - 1, input.shape[-1]))
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, (num_classes - 1,),
                                       is_bias=True)
        inputs["Bias"] = [bias]
    out = helper.create_tmp_variable(input.dtype, (input.shape[0], 1))
    helper.append_op(type="hsigmoid", inputs=inputs, outputs={"Cost": [out]},
                     attrs={"num_classes": num_classes})
    return out
