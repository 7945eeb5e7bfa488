"""Global flags read by the port, as plain in-process attributes. Only the
flags the ported paths read are defined, plus the JAX package's flags for
paths not ported yet, which may only stay off: turning one on raises
rather than being ignored."""

from __future__ import annotations

from typing import Dict, Union


class _Flags:
    """Attribute access over a fixed set of flags: `FLAGS.use_fused_rnn`."""

    def __init__(self, defaults: Dict[str, Union[bool, int]], unported: Dict[str, str]):
        object.__setattr__(self, "_values", dict(defaults))
        object.__setattr__(self, "_unported", dict(unported))

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            if name in self._unported:
                return False
            raise AttributeError(f"undefined flag {name!r}") from None

    def __setattr__(self, name: str, value):
        if name in self._unported:
            if value:
                raise NotImplementedError(
                    f"FLAGS.{name}: {self._unported[name]} is not ported to the "
                    "PyTorch port yet (ROADMAP.md, queue B)")
            return
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
}, unported={
    "fused_attention_seq_fwd": "the whole-sequence decoder forward kernel (B9)",
    "fused_attention_seq_bwd": "the decoder mega backward kernel (B10)",
    "bn_bf16_stats": "batch-norm statistics squared in the io dtype",
})
