"""Device resolution.

The port's entry points run on the card unless the caller names the CPU:
`device=None` means "cuda", and asking for CUDA where there is none raises
rather than running on the CPU without saying so.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # the index makes it compare equal to the device of a tensor on it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
