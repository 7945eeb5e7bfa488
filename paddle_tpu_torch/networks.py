"""Composite network builders (paddle_tpu/networks.py): the reference's
trainer_config_helpers networks and fluid nets, each a few layers of
`paddle_tpu_torch.layers`. The LSTM and GRU builders run `dynamic_lstm`
and `dynamic_gru` (the LSTM and GRU kernels on the card). Beyond the JAX
builders' arguments they take `max_len`, which those layers take: the
recurrence's steps, at least the longest sequence; by default, as there,
the LoDArray's capacity. It is for feeds whose capacity lies far above
their longest sequence (a reader that packs a batch's tokens into a
fixed capacity): the recurrence runs step by step, so each step past the
longest sequence is a launch and its work spent on padding. While every
sequence fits, the output is the JAX builder's."""

from __future__ import annotations

from typing import Sequence

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool", "text_conv_pool",
           "simple_lstm", "simple_gru", "bidirectional_lstm", "bidirectional_gru", "glu"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size, pool_stride=None,
                         act="relu", pool_type="max", param_attr=None, bias_attr=None):
    """conv2d, then pool2d."""
    conv = layers.conv2d(input, num_filters=num_filters, filter_size=filter_size, act=act,
                         param_attr=param_attr, bias_attr=bias_attr)
    return layers.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride or pool_size)


def img_conv_group(input, conv_num_filter: Sequence[int], conv_filter_size=3, conv_act="relu",
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0, pool_size=2,
                   pool_stride=2, pool_type="max", is_test=False):
    """3x3 convs (each with batch_norm and, but for the last, dropout when
    asked), then one pool: the VGG block."""
    tmp = input
    n = len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        tmp = layers.conv2d(tmp, num_filters=nf, filter_size=conv_filter_size, padding=1,
                            act=None if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(tmp, act=conv_act, is_test=is_test)
            if conv_batchnorm_drop_rate and i != n - 1:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate, is_test=is_test)
    return layers.pool2d(tmp, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type=pool_type)


def sequence_conv_pool(input, num_filters, filter_size, act="tanh", pool_type="max",
                       param_attr=None):
    """sequence_conv, then sequence_pool: the text-conv recipe."""
    conv = layers.sequence_conv(input, num_filters=num_filters, filter_size=filter_size,
                                act=act, param_attr=param_attr)
    return layers.sequence_pool(conv, pool_type)


text_conv_pool = sequence_conv_pool


def simple_lstm(input, size, reverse=False, act="tanh", gate_act="sigmoid", max_len=None):
    """An fc projection to 4·size, then dynamic_lstm."""
    proj = layers.fc(input, size=size * 4, bias_attr=False)
    return layers.dynamic_lstm(proj, size=size * 4, is_reverse=reverse,
                               candidate_activation=act, gate_activation=gate_act,
                               max_len=max_len)


def simple_gru(input, size, reverse=False, act="tanh", gate_act="sigmoid", max_len=None):
    """An fc projection to 3·size, then dynamic_gru."""
    proj = layers.fc(input, size=size * 3, bias_attr=False)
    return layers.dynamic_gru(proj, size=size, is_reverse=reverse, candidate_activation=act,
                              gate_activation=gate_act, max_len=max_len)


def bidirectional_lstm(input, size, return_unit=False, act="tanh", max_len=None):
    """A forward and a reverse simple_lstm: their outputs joined along the
    features, or the two as a list with return_unit."""
    fwd = simple_lstm(input, size, reverse=False, act=act, max_len=max_len)
    bwd = simple_lstm(input, size, reverse=True, act=act, max_len=max_len)
    if return_unit:
        return [fwd, bwd]
    return layers.sequence_concat([fwd, bwd])


def bidirectional_gru(input, size, act="tanh", max_len=None):
    fwd = simple_gru(input, size, reverse=False, act=act, max_len=max_len)
    bwd = simple_gru(input, size, reverse=True, act=act, max_len=max_len)
    return layers.sequence_concat([fwd, bwd])


def glu(input, dim=-1):
    """The gated linear unit: input split in two along `dim`, a·sigmoid(b)."""
    a, b = layers.split(input, 2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))
