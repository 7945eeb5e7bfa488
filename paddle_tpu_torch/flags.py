"""Global flags read by the port, as plain in-process attributes. Only the
flags the ported paths read are defined; setting or reading any other
raises rather than being ignored."""

from __future__ import annotations

from typing import Dict, Union


class _Flags:
    """Attribute access over a fixed set of flags: `FLAGS.use_fused_rnn`."""

    def __init__(self, defaults: Dict[str, Union[bool, int]]):
        object.__setattr__(self, "_values", dict(defaults))

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"undefined flag {name!r}") from None

    def __setattr__(self, name: str, value):
        if name not in self._values:
            raise AttributeError(f"undefined flag {name!r}")
        # each flag keeps its default's type: a bool flag stores bool(value),
        # an int flag (fused_conv_dot_max_n) int(value)
        self._values[name] = type(self._values[name])(value)


FLAGS = _Flags({
    # dynamic_gru runs the hand-written GRU kernels (ops/rnn_kernels.py)
    # for sigmoid/tanh gates; off, it takes the plain gru_scan
    "use_fused_rnn": True,
    # attention_gru_decoder runs the hand-written Bahdanau attention
    # kernels (ops/attention_kernels.py) under its own backward; off, it
    # takes the plain scan formulation with autograd
    "use_fused_attention": True,
    # resnet_imagenet's NHWC training bottlenecks build through the fused
    # raw-stats protocol (fused_conv_bn / bn_stats / bn_apply); read when
    # the program is built
    "use_fused_conv": True,
    # fused_conv_bn runs its 1x1 conv as a 2-D product when its rows N <=
    # this, else as a 1x1 F.conv2d (the 4-D route)
    "fused_conv_dot_max_n": 0,
    # the 2-D product is the hand-written fused conv + BN kernel
    # (ops/fused_conv_kernels.py) where its eligibility holds; off, the
    # plain 2-D formula
    "fused_conv_pallas": False,
    # under use_fused_attention, the decoder's forward is one whole-sequence
    # kernel (csrc/decoder_seq.cu) instead of a per-step kernel in a loop;
    # off by default, as in the JAX package
    "fused_attention_seq_fwd": False,
    # the same for the decoder's backward: one whole-sequence kernel instead
    # of a per-step kernel in a loop and the phase-2 kernel
    "fused_attention_seq_bwd": False,
    # batch-norm statistics (batch_norm, bn_stats, fused_conv_bn's routes
    # other than the kernel) square the activation in its io dtype and sum
    # in f32; off, they square in f32. On by default, as in the JAX package
    "bn_bf16_stats": True,
})
