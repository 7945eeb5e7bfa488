"""Sequence layer DSL (paddle_tpu/layers/sequence.py): dynamic_lstm
(:41), stacked_lstm2 (:89), stacked_lstm (:140), dynamic_gru (:199),
simple_rnn (:233), the sequence_* layers (:252-347), kmax_seq_score,
sub_nested_seq, featmap_expand, eos_id (:350-385) and sequence_conv
(:394). They take ragged variables, a LoDArray at run time
(sub_nested_seq a 2-level one)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..initializer import XavierInitializer
from ..param_attr import ParamAttr
from .helper import LayerHelper

__all__ = ["dynamic_lstm", "stacked_lstm2", "stacked_lstm", "dynamic_gru", "simple_rnn",
           "sequence_pool", "sequence_softmax", "sequence_expand", "sequence_concat",
           "sequence_first_step", "sequence_last_step", "sequence_slice", "sequence_reshape",
           "sequence_reverse", "kmax_seq_score", "sub_nested_seq", "featmap_expand", "eos_id",
           "sequence_conv"]


def dynamic_lstm(input, size: int, use_peepholes: bool = False, is_reverse: bool = False,
                 gate_activation: str = "sigmoid", cell_activation: str = "tanh",
                 candidate_activation: str = "tanh", param_attr=None, bias_attr=None,
                 max_len: Optional[int] = None, name=None):
    """`size` is 4*hidden and `input` the [*, 4H] projection (an fc before).
    `max_len` bounds the time steps run and must be at least the longest
    sequence: steps past it are dropped. Default: the LoDArray capacity."""
    helper = LayerHelper("dynamic_lstm", name=name)
    hidden = size // 4
    w = helper.create_parameter(param_attr, (hidden, 4 * hidden),
                                default_initializer=XavierInitializer())
    bias_len = 4 * hidden + (3 * hidden if use_peepholes else 0)
    inputs = {"Input": [input], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, (bias_len,), is_bias=True)]
    out = helper.create_tmp_variable(input.dtype, (-1, hidden), lod_level=1)
    last_h = helper.create_tmp_variable(input.dtype, (-1, hidden))
    last_c = helper.create_tmp_variable(input.dtype, (-1, hidden))
    helper.append_op(
        type="dynamic_lstm", inputs=inputs,
        outputs={"Hidden": [out], "LastH": [last_h], "LastC": [last_c]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation, "cell_activation": cell_activation,
               "candidate_activation": candidate_activation, "max_len": max_len})
    return out


def stacked_lstm2(input, size: int, param_attr=None, bias_attr=None,
                  max_len: Optional[int] = None, name=None):
    """Two stacked LSTM layers with the inter-layer [H, 4H] projection
    absorbed into one op (benchmark/paddle/rnn/rnn.py's 2x stacked LSTM).
    `size` is 4*hidden; `input` the layer-1 [*, 4H] projection; `max_len`
    as dynamic_lstm's."""
    helper = LayerHelper("stacked_lstm2", name=name)
    hidden = size // 4
    xav = XavierInitializer()

    def weight(suffix):
        return helper.create_parameter(ParamAttr.derive(param_attr, helper.name, suffix),
                                       (hidden, 4 * hidden), default_initializer=xav)

    inputs = {"Input": [input], "Weight1": [weight("w1")], "WX2": [weight("wx2")],
              "Weight2": [weight("w2")]}
    if bias_attr is not False:
        for slot, suffix in (("Bias1", "b1"), ("Bias2", "b2")):
            inputs[slot] = [helper.create_parameter(
                ParamAttr.derive(bias_attr, helper.name, suffix), (4 * hidden,),
                is_bias=True)]
    out = helper.create_tmp_variable(input.dtype, (-1, hidden), lod_level=1)
    helper.append_op(type="stacked_lstm2", inputs=inputs, outputs={"Hidden": [out]},
                     attrs={"max_len": max_len})
    return out


def stacked_lstm(input, size: int, stacked_num: int, param_attr=None, bias_attr=None,
                 max_len: Optional[int] = None, name=None):
    """`stacked_num` LSTM layers with the book's inter-layer structure
    (understand_sentiment's stacked_lstm_net: layer i's input is
    fc([fc_prev, lstm_prev])) in one op. `size` is 4*hidden and `input` the
    layer-1 [*, 4H] projection. Returns (fc_out, hidden): the last
    inter-layer fc sequence and the last layer's hidden sequence, which the
    book max-pools both. `max_len` as dynamic_lstm's."""
    if stacked_num < 2:
        raise ValueError(f"stacked_num must be >= 2, got {stacked_num}")
    helper = LayerHelper("stacked_lstm", name=name)
    hidden = size // 4
    xav = XavierInitializer()

    def mk(suffix, shape):
        return helper.create_parameter(ParamAttr.derive(param_attr, helper.name, suffix), shape,
                                       default_initializer=xav)

    # the per-layer build's creation order: w0, then wa_i, wb_i, w_{i+1}
    ws = [mk("w0", (hidden, 4 * hidden))]
    was, wbs = [], []
    for i in range(stacked_num - 1):
        was.append(mk(f"wa{i}", (4 * hidden, 4 * hidden)))
        wbs.append(mk(f"wb{i}", (hidden, 4 * hidden)))
        ws.append(mk(f"w{i + 1}", (hidden, 4 * hidden)))
    inputs = {"Input": [input], "Weights": ws, "WAs": was, "WBs": wbs}
    if bias_attr is not False:
        def mkb(suffix):
            return helper.create_parameter(ParamAttr.derive(bias_attr, helper.name, suffix),
                                           (4 * hidden,), is_bias=True)

        inputs["Biases"] = [mkb(f"b{i}") for i in range(stacked_num)]
        inputs["FcBiases"] = [mkb(f"fb{i}") for i in range(stacked_num - 1)]
    fc_out = helper.create_tmp_variable(input.dtype, (-1, 4 * hidden), lod_level=1)
    out = helper.create_tmp_variable(input.dtype, (-1, hidden), lod_level=1)
    helper.append_op(type="stacked_lstm", inputs=inputs,
                     outputs={"FcOut": [fc_out], "Hidden": [out]}, attrs={"max_len": max_len})
    return fc_out, out


def dynamic_gru(input, size: int, is_reverse: bool = False, gate_activation: str = "sigmoid",
                candidate_activation: str = "tanh", param_attr=None, bias_attr=None,
                max_len: Optional[int] = None, name=None):
    """`size` is the hidden width H and `input` the [*, 3H] projection (an
    fc before); `max_len` as dynamic_lstm's."""
    helper = LayerHelper("dynamic_gru", name=name)
    w = helper.create_parameter(param_attr, (size, 3 * size),
                                default_initializer=XavierInitializer())
    inputs = {"Input": [input], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, (3 * size,), is_bias=True)]
    out = helper.create_tmp_variable(input.dtype, (-1, size), lod_level=1)
    last_h = helper.create_tmp_variable(input.dtype, (-1, size))
    helper.append_op(
        type="dynamic_gru", inputs=inputs, outputs={"Hidden": [out], "LastH": [last_h]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "candidate_activation": candidate_activation, "max_len": max_len})
    return out


def simple_rnn(input, size: int, activation: str = "tanh", param_attr=None, bias_attr=None,
               max_len: Optional[int] = None, name=None):
    """h_t = act(x_t + h_{t-1} W (+ b)) over [*, size] inputs (Gen-1
    RecurrentLayer); `max_len` as dynamic_lstm's."""
    helper = LayerHelper("simple_rnn", name=name)
    w = helper.create_parameter(param_attr, (size, size),
                                default_initializer=XavierInitializer())
    inputs = {"Input": [input], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, (size,), is_bias=True)]
    out = helper.create_tmp_variable(input.dtype, (-1, size), lod_level=1)
    helper.append_op(type="simple_rnn", inputs=inputs, outputs={"Hidden": [out]},
                     attrs={"activation": activation, "max_len": max_len})
    return out


def sequence_pool(input, pool_type: str = "sum", name=None):
    """Per-sequence pooling to a dense [num_seqs, D]: average, sum, sqrt,
    max, min, last or first."""
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_tmp_variable(input.dtype, (-1,) + tuple(input.shape[1:]))
    helper.append_op(type="sequence_pool", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooltype": pool_type})
    return out


def _seq_op(layer, inputs, out_dtype, out_shape, lod_level=1, attrs=None, name=None):
    """One op of type `layer` from `inputs` to a new variable."""
    helper = LayerHelper(layer, name=name)
    out = helper.create_tmp_variable(out_dtype, out_shape, lod_level=lod_level)
    helper.append_op(type=layer, inputs=inputs, outputs={"Out": [out]}, attrs=attrs)
    return out


def sequence_softmax(input, name=None):
    """Softmax within each sequence of a [*] or [*, 1] input."""
    return _seq_op("sequence_softmax", {"X": [input]}, input.dtype, input.shape, name=name)


def sequence_expand(x, y, name=None):
    """The rows of dense `x` broadcast over the tokens of ragged `y`'s
    sequences."""
    return _seq_op("sequence_expand", {"X": [x], "Y": [y]}, x.dtype, x.shape, name=name)


def sequence_concat(input, name=None):
    """The sequences of each input joined along the feature axis (equal
    lods): [*, D1 + D2 + ...]."""
    helper = LayerHelper("sequence_concat", name=name)
    feat = sum(int(x.shape[-1]) for x in input)
    out = helper.create_tmp_variable(input[0].dtype, tuple(input[0].shape[:-1]) + (feat,),
                                     lod_level=1)
    helper.append_op(type="sequence_concat", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def sequence_first_step(input, name=None):
    """Each sequence's first token, a dense [num_seqs, D]."""
    helper = LayerHelper("sequence_first_step", name=name)
    out = helper.create_tmp_variable(input.dtype, (-1,) + tuple(input.shape[1:]))
    helper.append_op(type="sequence_first_step", inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def sequence_last_step(input, name=None):
    """Each sequence's last token, a dense [num_seqs, D]."""
    return _seq_op("sequence_last_step", {"X": [input]}, input.dtype,
                   (-1,) + tuple(input.shape[1:]), lod_level=0, name=name)


def sequence_slice(input, offset, length, name=None):
    """[offset, offset + length) of each sequence, both per sequence."""
    return _seq_op("sequence_slice", {"X": [input], "Offset": [offset], "Length": [length]},
                   input.dtype, input.shape, name=name)


def sequence_reshape(input, new_dim, name=None):
    """The feature axis refactored to `new_dim`, lengths scaled to match."""
    return _seq_op("sequence_reshape", {"X": [input]}, input.dtype, (-1, new_dim),
                   attrs={"new_dim": new_dim}, name=name)


def sequence_reverse(input, name=None):
    """Each sequence's tokens in reverse order."""
    return _seq_op("sequence_reverse", {"X": [input]}, input.dtype, input.shape, name=name)


def kmax_seq_score(input, beam_size=1, name=None):
    """The indices of each sequence's `beam_size` best scores, -1 past its
    length: an int32 [num_seqs, beam_size]."""
    return _seq_op("kmax_seq_score", {"X": [input]}, np.int32, (-1, beam_size), lod_level=0,
                   attrs={"beam_size": beam_size}, name=name)


def sub_nested_seq(input, selection, name=None):
    """The sub-sequences of a 2-level input picked by batch-wide index."""
    return _seq_op("sub_nested_seq", {"X": [input], "Selection": [selection]}, input.dtype,
                   input.shape, name=name)


def featmap_expand(input, num_filters, as_row_vector=True, name=None):
    """Each token's features repeated `num_filters` times."""
    return _seq_op("featmap_expand", {"X": [input]}, input.dtype,
                   (-1, input.shape[-1] * num_filters),
                   attrs={"num_filters": num_filters, "as_row_vector": as_row_vector},
                   name=name)


def eos_id(input, eos_id, name=None):
    """1.0 on the tokens whose id is `eos_id`: an f32 [*, 1]."""
    return _seq_op("eos_id", {"X": [input]}, np.float32, (-1, 1), attrs={"eos_id": eos_id},
                   name=name)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1, context_start=None,
                  padding=True, param_attr=None, bias_attr=None, act=None, name=None):
    """A context-window convolution over each sequence (sequence_conv_op,
    ContextProjection + fc): windows of `filter_size` tokens from
    `context_start` (default -filter_size // 2), zero outside the
    sequence; the Filter [filter_size·D, num_filters]."""
    if filter_stride != 1:
        raise ValueError("sequence_conv: the reference supports stride 1 only")
    if padding is not True:
        raise NotImplementedError(
            "sequence_conv: only zero-clipped boundary windows (padding=True) are "
            "implemented; the reference's trainable padding rows are not")
    helper = LayerHelper("sequence_conv", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, (filter_size * d, num_filters))
    inputs = {"X": [input], "Filter": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, (num_filters,), is_bias=True)]
    out = helper.create_tmp_variable(input.dtype, (-1, num_filters), lod_level=1)
    helper.append_op(type="sequence_conv", inputs=inputs, outputs={"Out": [out]},
                     attrs={"context_length": filter_size,
                            "context_start": (-(filter_size // 2) if context_start is None
                                              else context_start)})
    return helper.append_activation(out, act)
