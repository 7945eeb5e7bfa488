"""Layer DSL (paddle_tpu/layers/nn.py): data (:73), fc (:96), embedding
(:146), conv2d (:198), conv2d_transpose (:250), pool2d (:278), batch_norm
(:348), the fused conv + BN protocol's RawConvBN (:376), fused_conv_bn
(:394), bn_stats (:451) and bn_apply (:477), layer_norm (:492), dropout
(:512), cross_entropy (:525), softmax_with_cross_entropy (:537),
square_error_cost (:554), accuracy (:565), mean, softmax, relu, sigmoid,
tanh (:602-618), the elementwise layers (:622-634), scale (:638), cast
(:642), fill_constant (:652), increment (:669), concat (:680), reshape,
transpose, matmul, clip (:696-709), reduce_sum, reduce_mean (:725-733),
split (:741), expand (:754), topk (:758), argmax (:769), lrn (:779), the
comparisons (:808) and logical_and, logical_not (:833). Each builds its
parameters through LayerHelper and appends ops to the default program;
shapes use -1 for the batch dimension."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.program import Variable, default_main_program
from ..initializer import ConstantInitializer, NormalInitializer
from ..param_attr import ParamAttr
from .helper import LayerHelper

__all__ = ["data", "fc", "embedding", "conv2d", "conv2d_transpose", "pool2d", "batch_norm",
           "RawConvBN", "fused_conv_bn", "bn_stats", "bn_apply", "layer_norm", "dropout",
           "cross_entropy", "softmax_with_cross_entropy", "square_error_cost", "accuracy",
           "mean", "softmax", "relu", "sigmoid", "tanh", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "scale", "cast", "fill_constant", "increment",
           "concat", "reshape", "transpose", "matmul", "clip", "reduce_sum", "reduce_mean",
           "split", "expand", "topk", "argmax", "lrn", "less_than", "less_equal",
           "greater_than", "greater_equal", "equal", "not_equal", "logical_and",
           "logical_not"]


def data(name: str, shape: Sequence[int], dtype=np.float32, lod_level: int = 0,
         append_batch_size: bool = True, sparse_format: Optional[str] = None) -> Variable:
    """Declares a feed variable; shape excludes the batch dimension when
    append_batch_size=True. sparse_format="binary" or "float" declares a
    sparse slot of shape [dim], fed a SparseArray (core/sparse.py)."""
    if sparse_format not in (None, "binary", "float"):
        raise ValueError(f"sparse_format must be 'binary'/'float', got {sparse_format!r}")
    block = default_main_program().current_block()
    full_shape = ((-1,) + tuple(shape)) if append_batch_size else tuple(shape)
    return block.create_var(name, full_shape, dtype, lod_level=lod_level,
                            sparse_format=sparse_format)


def fc(input, size: int, act: Optional[str] = None, num_flatten_dims: int = 1,
       param_attr=None, bias_attr=None, name=None) -> Variable:
    """input @ W (+ b), then `act`. Several inputs are each multiplied by
    their own W and summed (MixedLayer semantics); `param_attr` may be a
    list, one for each input."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_outs = []
    for i, inp in enumerate(inputs):
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(
            param_attr[i] if isinstance(param_attr, (list, tuple)) else param_attr,
            shape=(in_dim, size), dtype=inp.dtype)
        out = helper.create_tmp_variable(inp.dtype, inp.shape[:num_flatten_dims] + (size,),
                                         inp.lod_level)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]}, outputs={"Out": [out]},
                         attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_outs.append(out)
    if len(mul_outs) == 1:
        pre_bias = mul_outs[0]
    else:
        pre_bias = helper.create_tmp_variable(inputs[0].dtype, mul_outs[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_outs}, outputs={"Out": [pre_bias]})
    if bias_attr is False:
        return helper.append_activation(pre_bias, act)
    b = helper.create_parameter(bias_attr, shape=(size,), is_bias=True)
    pre_act = helper.create_tmp_variable(pre_bias.dtype, pre_bias.shape, pre_bias.lod_level)
    helper.append_op(type="elementwise_add", inputs={"X": [pre_bias], "Y": [b]},
                     outputs={"Out": [pre_act]}, attrs={"axis": -1})
    return helper.append_activation(pre_act, act)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              padding_idx: Optional[int] = None, param_attr=None, dtype=np.float32,
              name=None) -> Variable:
    """Table lookup. is_sparse=True gives the table row-wise SelectedRows
    gradients (core/sparse.py) and lazy optimizer updates."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=tuple(size), dtype=dtype,
                                default_initializer=NormalInitializer(0.0, 0.01))
    if is_sparse:
        w.sparse_update = True
    out = helper.create_tmp_variable(dtype, input.shape + (size[1],), input.lod_level)
    helper.append_op(type="lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse, "padding_idx": padding_idx})
    return out


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _conv_out_hw(hw, ksize, stride, padding, dilation=1):
    """Static output spatial dims; -1 propagates unknowns."""
    k, s, p, d = _pair(ksize), _pair(stride), _pair(padding), _pair(dilation)
    return tuple(-1 if hw[i] == -1 else (hw[i] + 2 * p[i] - (d[i] * (k[i] - 1) + 1)) // s[i] + 1
                 for i in range(2))


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0, dilation=1,
           groups: int = 1, act: Optional[str] = None, param_attr=None, bias_attr=None,
           name=None, data_format: str = "NCHW") -> Variable:
    """The filter is OIHW in either layout, initialised N(0, sqrt(2 /
    fan_in)); an NHWC input gives an NHWC output."""
    helper = LayerHelper("conv2d", name=name)
    in_c = input.shape[1] if data_format == "NCHW" else input.shape[3]
    fh, fw = _pair(filter_size)
    fan_in = (in_c // groups) * fh * fw
    w = helper.create_parameter(param_attr, (num_filters, in_c // groups, fh, fw),
                                default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    inputs = {"Input": [input], "Filter": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, (num_filters,), is_bias=True)]
    hw_in = input.shape[2:4] if data_format == "NCHW" else input.shape[1:3]
    out_hw = _conv_out_hw(hw_in, (fh, fw), stride, padding, dilation)
    out_shape = ((-1, num_filters) + out_hw if data_format == "NCHW"
                 else (-1,) + out_hw + (num_filters,))
    out = helper.create_tmp_variable(input.dtype, out_shape)
    helper.append_op(type="conv2d", inputs=inputs, outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding, "dilations": dilation,
                            "groups": groups, "data_format": data_format})
    return helper.append_activation(out, act)


def conv2d_transpose(input, num_filters: int, filter_size, stride=1, padding=0,
                     param_attr=None, bias_attr=None, act: Optional[str] = None,
                     name=None) -> Variable:
    """The transpose of conv2d (NCHW): its Filter [in_c, num_filters, kh,
    kw] Xavier-initialised, the output (H - 1)·stride - 2·padding + kh
    high."""
    helper = LayerHelper("conv2d_transpose", name=name)
    in_c = input.shape[1]
    fh, fw = _pair(filter_size)
    w = helper.create_parameter(param_attr, (in_c, num_filters, fh, fw))
    s, p = _pair(stride), _pair(padding)
    inputs = {"Input": [input], "Filter": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, (num_filters,), is_bias=True)]
    out_hw = tuple(-1 if input.shape[2 + i] == -1
                   else (input.shape[2 + i] - 1) * s[i] - 2 * p[i] + (fh, fw)[i]
                   for i in range(2))
    out = helper.create_tmp_variable(input.dtype, (-1, num_filters) + out_hw)
    helper.append_op(type="conv2d_transpose", inputs=inputs, outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding})
    return helper.append_activation(out, act)


def pool2d(input, pool_size=2, pool_type: str = "max", pool_stride=None, pool_padding=0,
           global_pooling: bool = False, exclusive: bool = True, name=None,
           data_format: str = "NCHW") -> Variable:
    helper = LayerHelper("pool2d", name=name)
    hw_in = input.shape[2:4] if data_format == "NCHW" else input.shape[1:3]
    c = input.shape[1] if data_format == "NCHW" else input.shape[3]
    stride = pool_stride if pool_stride is not None else pool_size
    out_hw = (1, 1) if global_pooling else _conv_out_hw(hw_in, pool_size, stride, pool_padding)
    out_shape = (-1, c) + out_hw if data_format == "NCHW" else (-1,) + out_hw + (c,)
    out = helper.create_tmp_variable(input.dtype, out_shape)
    helper.append_op(type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size, "strides": stride,
                            "paddings": pool_padding, "global_pooling": global_pooling,
                            "exclusive": exclusive, "data_format": data_format})
    return out


def _create_bn_params(helper, c, param_attr=None, bias_attr=None):
    """Scale (ones) and bias (zeros) trainables, then the running mean
    (zeros) and variance (ones) persistables `{name}.mean` and
    `{name}.variance`, in the order batch_norm and the fused protocol
    both create them."""
    scale = helper.create_parameter(param_attr, (c,),
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, (c,), is_bias=True)
    mean = helper.create_parameter(ParamAttr(name=f"{helper.name}.mean"), (c,),
                                   default_initializer=ConstantInitializer(0.0))
    var = helper.create_parameter(ParamAttr(name=f"{helper.name}.variance"), (c,),
                                  default_initializer=ConstantInitializer(1.0))
    for v in (mean, var):  # state, not trainable weights
        v.trainable = False
        v.is_parameter = False
    return scale, bias, mean, var


def batch_norm(input, act: Optional[str] = None, momentum: float = 0.9, epsilon: float = 1e-5,
               is_test: bool = False, param_attr=None, bias_attr=None, name=None,
               data_format: str = "NCHW") -> Variable:
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    scale, bias, mean, var = _create_bn_params(helper, c, param_attr, bias_attr)
    out = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(type="batch_norm",
                     inputs={"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean],
                             "Variance": [var]},
                     outputs={"Y": [out]},
                     attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
                            "data_format": data_format})
    return helper.append_activation(out, act)


class RawConvBN:
    """A raw (pre-BatchNorm) activation with the batch statistics and the
    parameters that normalise it, the currency of the fused conv + BN
    protocol (ops/fused_conv_ops.py): a consumer normalises it (bn_apply)
    or hands it to the next fused_conv_bn, whose prologue normalises it."""

    __slots__ = ("out", "mean", "inv", "scale", "bias")

    def __init__(self, out, mean, inv, scale, bias):
        self.out, self.mean, self.inv, self.scale, self.bias = out, mean, inv, scale, bias


def fused_conv_bn(input, num_filters: int, stride: int = 1,
                  prologue_act: Optional[str] = "relu", momentum: float = 0.9,
                  epsilon: float = 1e-5, param_attr=None, bn_param_attr=None, bn_bias_attr=None,
                  name=None) -> RawConvBN:
    """1x1 conv + BatchNorm (NHWC, train mode) through the fused protocol.
    `input` is a Variable (no prologue) or a RawConvBN (its normalise and
    `prologue_act` run in this conv's prologue). The parameter names are
    an unfused conv2d + batch_norm's; `name` names the BN half."""
    prologue = isinstance(input, RawConvBN)
    x = input.out if prologue else input
    in_c = x.shape[3]
    conv_helper = LayerHelper("conv2d")
    w = conv_helper.create_parameter(param_attr, (num_filters, in_c, 1, 1),
                                     default_initializer=NormalInitializer(0.0, (2.0 / in_c) ** 0.5))
    scale, bias, mean, var = _create_bn_params(LayerHelper("batch_norm", name=name), num_filters,
                                               bn_param_attr, bn_bias_attr)
    out_hw = tuple(-1 if d == -1 else (d + stride - 1) // stride for d in x.shape[1:3])
    out = conv_helper.create_tmp_variable(x.dtype, (-1,) + out_hw + (num_filters,))
    bmean = conv_helper.create_tmp_variable(np.float32, (num_filters,))
    binv = conv_helper.create_tmp_variable(np.float32, (num_filters,))
    inputs = {"X": [x], "Filter": [w], "Mean": [mean], "Variance": [var]}
    if prologue:
        inputs.update({"XMean": [input.mean], "XInv": [input.inv], "XScale": [input.scale],
                       "XBias": [input.bias]})
    conv_helper.append_op(type="fused_conv_bn", inputs=inputs,
                          outputs={"Out": [out], "BatchMean": [bmean], "BatchInv": [binv]},
                          attrs={"stride": stride, "epsilon": epsilon, "momentum": momentum,
                                 "prologue_act": prologue_act})
    return RawConvBN(out, bmean, binv, scale, bias)


def bn_stats(input, momentum: float = 0.9, epsilon: float = 1e-5, param_attr=None,
             bias_attr=None, name=None) -> RawConvBN:
    """The statistics half of a BatchNorm over a raw NHWC activation; its
    normalise runs in bn_apply or a fused_conv_bn prologue."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[-1]
    scale, bias, mean, var = _create_bn_params(helper, c, param_attr, bias_attr)
    bmean = helper.create_tmp_variable(np.float32, (c,))
    binv = helper.create_tmp_variable(np.float32, (c,))
    helper.append_op(type="bn_stats", inputs={"X": [input], "Mean": [mean], "Variance": [var]},
                     outputs={"BatchMean": [bmean], "BatchInv": [binv]},
                     attrs={"epsilon": epsilon, "momentum": momentum})
    return RawConvBN(input, bmean, binv, scale, bias)


def bn_apply(raw: RawConvBN, act: Optional[str] = None, name=None) -> Variable:
    """The normalised activation of a RawConvBN (and `act`)."""
    helper = LayerHelper("bn_apply", name=name)
    out = helper.create_tmp_variable(raw.out.dtype, raw.out.shape)
    helper.append_op(type="bn_apply",
                     inputs={"X": [raw.out], "Mean": [raw.mean], "Inv": [raw.inv],
                             "Scale": [raw.scale], "Bias": [raw.bias]},
                     outputs={"Out": [out]}, attrs={"act": act})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5, name=None):
    """Normalises over the axes from begin_norm_axis on, with a learned
    scale (ones) and shift (zeros) over those axes' elements."""
    helper = LayerHelper("layer_norm", name=name)
    dim = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            None, (dim,), default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(None, (dim,), is_bias=True)]
    out = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(type="layer_norm", inputs=inputs, outputs={"Y": [out]},
                     attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return out


def dropout(x, dropout_prob: float, is_test: bool = False, name=None) -> Variable:
    """v0.11's dropout (ops/nn_ops.py): x · Bernoulli(1 − p) mask in
    training, x · (1 − p) with is_test; a LoD input keeps its LoD."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="dropout", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test})
    return out


def cross_entropy(input, label, soft_label: bool = False) -> Variable:
    """-log(input[label]) of probability rows, [N, 1]."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype, (input.shape[0], 1))
    helper.append_op(type="cross_entropy", inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]}, attrs={"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label: bool = False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_tmp_variable(logits.dtype, logits.shape,
                                             lod_level=logits.lod_level)
    loss = helper.create_tmp_variable(logits.dtype, (logits.shape[0], 1),
                                      lod_level=logits.lod_level)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def square_error_cost(input, label) -> Variable:
    """(input - label)², elementwise."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(type="square_error_cost", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def accuracy(input, label, k: int = 1) -> Variable:
    """The top-k accuracy of `input`'s rows against `label`: a `top_k` op,
    then an `accuracy` op."""
    helper = LayerHelper("accuracy")
    vals = helper.create_tmp_variable(input.dtype, input.shape[:-1] + (k,))
    idxs = helper.create_tmp_variable(np.int32, input.shape[:-1] + (k,))
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [vals], "Indices": [idxs]}, attrs={"k": k})
    acc = helper.create_tmp_variable(np.float32, ())
    helper.append_op(type="accuracy", inputs={"Indices": [idxs], "Label": [label]},
                     outputs={"Accuracy": [acc]})
    return acc


def mean(x):
    helper = LayerHelper("mean")
    out = helper.create_tmp_variable(x.dtype, (), x.lod_level)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={})
    return out


def softmax(x):
    helper = LayerHelper("softmax")
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="softmax", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={})
    return out


def relu(x):
    helper = LayerHelper("relu")
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={})
    return out


def _unary(op_type, x, attrs=None, out_shape=None):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(x.dtype, x.shape if out_shape is None else out_shape,
                                     x.lod_level)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def _binary(op_type, x, y, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def sigmoid(x):
    return _unary("sigmoid", x)


def tanh(x):
    return _unary("tanh", x)


def elementwise_add(x, y, axis=-1):
    """x + y, y broadcast onto a contiguous run of x's axes from `axis`."""
    return _binary("elementwise_add", x, y, {"axis": axis})


def elementwise_sub(x, y, axis=-1):
    return _binary("elementwise_sub", x, y, {"axis": axis})


def elementwise_mul(x, y, axis=-1):
    return _binary("elementwise_mul", x, y, {"axis": axis})


def elementwise_div(x, y, axis=-1):
    return _binary("elementwise_div", x, y, {"axis": axis})


def scale(x, scale=1.0, bias=0.0):
    """x * scale + bias."""
    helper = LayerHelper("scale")
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias})
    return out


def cast(x, dtype):
    """x's values as `dtype` (a numpy dtype or its name)."""
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(np.dtype(dtype), x.shape, x.lod_level)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"dtype": np.dtype(dtype).name})
    return out


def fill_constant(shape, dtype, value):
    """A `shape` tensor of `value` (fill_constant_op.cc)."""
    helper = LayerHelper("fill_constant")
    out = helper.create_tmp_variable(np.dtype(dtype), tuple(shape))
    helper.append_op(type="fill_constant", inputs={}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": np.dtype(dtype).name,
                            "value": value})
    return out


def increment(x, value=1.0):
    """x + value, in x's dtype (increment_op.cc)."""
    return _unary("increment", x, {"step": value})


def concat(input, axis=0):
    """The inputs joined along `axis` (-1 there when any input's is)."""
    helper = LayerHelper("concat")
    shape = list(input[0].shape)
    ax = axis if axis >= 0 else len(shape) + axis
    if all(v.shape[ax] != -1 for v in input):
        shape[ax] = sum(v.shape[ax] for v in input)
    else:
        shape[ax] = -1
    out = helper.create_tmp_variable(input[0].dtype, tuple(shape))
    helper.append_op(type="concat", inputs={"X": list(input)}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def reshape(x, shape):
    """x's data to `shape` (-1 for one inferred axis), a dense variable."""
    helper = LayerHelper("reshape")
    out = helper.create_tmp_variable(x.dtype, tuple(shape), x.lod_level)
    helper.append_op(type="reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return out


def transpose(x, perm):
    return _unary("transpose", x, {"axis": list(perm)},
                  out_shape=tuple(x.shape[i] for i in perm))


def matmul(x, y, transpose_x=False, transpose_y=False):
    return _binary("matmul", x, y, {"transpose_X": transpose_x, "transpose_Y": transpose_y})


def clip(x, min, max):  # noqa: A002 (fluid's layers.clip signature)
    return _unary("clip", x, {"min": float(min), "max": float(max)})


def _reduced_shape(shape, dim, keep_dim):
    if dim is None:
        return (1,) * len(shape) if keep_dim else ()
    dims = {d % len(shape) for d in ((dim,) if isinstance(dim, int) else dim)}
    if keep_dim:
        return tuple(1 if i in dims else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in dims)


def reduce_sum(x, dim=None, keep_dim=False):
    """Over `dim` (an int or a list), every axis when None."""
    return _unary("reduce_sum", x, {"dim": dim, "keep_dim": keep_dim, "reduce_all": dim is None},
                  out_shape=_reduced_shape(x.shape, dim, keep_dim))


def reduce_mean(x, dim=None, keep_dim=False):
    return _unary("reduce_mean", x,
                  {"dim": dim, "keep_dim": keep_dim, "reduce_all": dim is None},
                  out_shape=_reduced_shape(x.shape, dim, keep_dim))


def split(x, num_or_sections, dim=0):
    """Into `num_or_sections` equal parts, or parts of those sizes."""
    helper = LayerHelper("split")
    if isinstance(num_or_sections, int):
        n, attrs = num_or_sections, {"num": num_or_sections, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_tmp_variable(x.dtype, x.shape) for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [x]}, outputs={"Out": outs}, attrs=attrs)
    return outs


def expand(x, expand_times):
    """x tiled `expand_times` along each axis."""
    return _unary("expand", x, {"expand_times": list(expand_times)})


def topk(input, k=1):
    """The k largest values of each row and their int32 indices."""
    helper = LayerHelper("top_k")
    vals = helper.create_tmp_variable(input.dtype, input.shape[:-1] + (k,))
    idxs = helper.create_tmp_variable(np.int32, input.shape[:-1] + (k,))
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [vals], "Indices": [idxs]}, attrs={"k": k})
    return vals, idxs


def argmax(x, axis=-1):
    helper = LayerHelper("argmax")
    out = helper.create_tmp_variable(np.int32, x.shape[:-1])
    helper.append_op(type="argmax", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75):
    """Local response normalisation across NCHW channels (ops/nn_ops.py)."""
    helper = LayerHelper("lrn")
    out = helper.create_tmp_variable(input.dtype, input.shape, input.lod_level)
    helper.append_op(type="lrn", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def _broadcast_static_shape(a, b):
    """numpy's broadcast of two static shapes, -1 an unknown extent."""
    a, b = tuple(a), tuple(b)
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + a, (1,) * (n - len(b)) + b
    return tuple((-1 if max(x, y) in (-1, 1) else max(x, y)) if -1 in (x, y) else max(x, y)
                 for x, y in zip(a, b))


def _compare_layer(op_type, x, y):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(np.bool_, _broadcast_static_shape(x.shape, y.shape),
                                     x.lod_level)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def less_than(x, y):
    return _compare_layer("less_than", x, y)


def less_equal(x, y):
    return _compare_layer("less_equal", x, y)


def greater_than(x, y):
    return _compare_layer("greater_than", x, y)


def greater_equal(x, y):
    return _compare_layer("greater_equal", x, y)


def equal(x, y):
    return _compare_layer("equal", x, y)


def not_equal(x, y):
    return _compare_layer("not_equal", x, y)


def logical_and(x, y):
    return _compare_layer("logical_and", x, y)


def logical_not(x):
    helper = LayerHelper("logical_not")
    out = helper.create_tmp_variable(np.bool_, x.shape, x.lod_level)
    helper.append_op(type="logical_not", inputs={"X": [x]}, outputs={"Out": [out]})
    return out
