"""Global flags read by the port, as plain in-process attributes. Only the
flags the ported paths read are defined."""

from __future__ import annotations

from typing import Dict


class _Flags:
    """Attribute access over a fixed set of flags: `FLAGS.use_fused_rnn`."""

    def __init__(self, defaults: Dict[str, bool]):
        object.__setattr__(self, "_values", dict(defaults))

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"undefined flag {name!r}") from None

    def __setattr__(self, name: str, value):
        if name not in self._values:
            raise AttributeError(f"undefined flag {name!r}")
        self._values[name] = bool(value)


FLAGS = _Flags({
    # dynamic_gru runs the hand-written GRU forward (ops/rnn_kernels.py)
    # for sigmoid/tanh gates; off, it takes the plain gru_scan
    "use_fused_rnn": True,
})
