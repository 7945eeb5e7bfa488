"""Global flags read by the port, as plain in-process attributes. Only the
flags the ported paths read are defined, plus the JAX package's flags for
paths not ported yet, which may only stay off: turning one on raises
rather than being ignored."""

from __future__ import annotations

from typing import Dict


class _Flags:
    """Attribute access over a fixed set of flags: `FLAGS.use_fused_rnn`."""

    def __init__(self, defaults: Dict[str, bool], unported: Dict[str, str]):
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
        self._values[name] = bool(value)


FLAGS = _Flags({
    # dynamic_gru runs the hand-written GRU kernels (ops/rnn_kernels.py)
    # for sigmoid/tanh gates; off, it takes the plain gru_scan
    "use_fused_rnn": True,
    # attention_gru_decoder runs the hand-written Bahdanau attention
    # kernels (ops/attention_kernels.py) under its own backward; off, it
    # takes the plain scan formulation with autograd
    "use_fused_attention": True,
}, unported={
    "fused_attention_seq_fwd": "the whole-sequence decoder forward kernel (B9)",
    "fused_attention_seq_bwd": "the decoder mega backward kernel (B10)",
})
