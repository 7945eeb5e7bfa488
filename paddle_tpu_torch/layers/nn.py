"""Layer DSL (paddle_tpu/layers/nn.py), cut to the layers the ported
programs use: data (:73), fc (:96), embedding (:146), layer_norm (:492),
softmax_with_cross_entropy (:537), mean (:602) and elementwise_add
(:622). Each builds its parameters through LayerHelper and appends ops
to the default program; shapes use -1 for the batch dimension."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.program import Variable, default_main_program
from ..initializer import ConstantInitializer, NormalInitializer
from .helper import LayerHelper

__all__ = ["data", "fc", "embedding", "layer_norm", "softmax_with_cross_entropy", "mean",
           "elementwise_add"]


def data(name: str, shape: Sequence[int], dtype=np.float32, lod_level: int = 0,
         append_batch_size: bool = True, sparse_format: Optional[str] = None) -> Variable:
    """Declares a feed variable; shape excludes the batch dimension when
    append_batch_size=True."""
    if sparse_format is not None:
        raise NotImplementedError("sparse feed slots are not ported to the PyTorch port yet")
    block = default_main_program().current_block()
    full_shape = ((-1,) + tuple(shape)) if append_batch_size else tuple(shape)
    return block.create_var(name, full_shape, dtype, lod_level=lod_level)


def fc(input, size: int, act: Optional[str] = None, num_flatten_dims: int = 1,
       param_attr=None, bias_attr=None, name=None) -> Variable:
    """input @ W (+ b), then `act`. One input: the port has no `sum` op
    for the JAX package's several-input form yet."""
    if isinstance(input, (list, tuple)):
        if len(input) != 1:
            raise NotImplementedError("fc over several inputs needs the `sum` op, which "
                                      "is not ported to the PyTorch port yet")
        input = input[0]
        param_attr = param_attr[0] if isinstance(param_attr, (list, tuple)) else param_attr
    helper = LayerHelper("fc", name=name)
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, shape=(in_dim, size), dtype=input.dtype)
    pre_bias = helper.create_tmp_variable(
        input.dtype, input.shape[:num_flatten_dims] + (size,), input.lod_level)
    helper.append_op(type="mul", inputs={"X": [input], "Y": [w]}, outputs={"Out": [pre_bias]},
                     attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
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
    """Table lookup. is_sparse=True marks the table for SelectedRows
    gradients, which the executor refuses until they are ported."""
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


def mean(x):
    helper = LayerHelper("mean")
    out = helper.create_tmp_variable(x.dtype, (), x.lod_level)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={})
    return out


def elementwise_add(x, y, axis=-1):
    """x + y, y broadcast onto a contiguous run of x's axes from `axis`."""
    helper = LayerHelper("elementwise_add")
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="elementwise_add", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
