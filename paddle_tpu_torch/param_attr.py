"""ParamAttr: per-parameter configuration (paddle_tpu/param_attr.py):
name, initializer, regularizer, trainable, gradient clip. A
learning-rate multiplier other than 1 raises when the parameter is
created; update hooks (StaticPruningHook) need the prune_mask_init
and apply_mask ops, which are not ported yet."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional


class StaticPruningHook:
    """Mask-based static sparsity: not ported yet."""

    def __init__(self, sparsity_ratio: float = 0.8):
        raise NotImplementedError(
            "StaticPruningHook needs the prune_mask_init and apply_mask ops, "
            "which are not ported to the PyTorch port yet")


@dataclass
class ParamAttr:
    name: Optional[str] = None
    initializer: Any = None
    learning_rate: float = 1.0
    regularizer: Any = None
    trainable: bool = True
    gradient_clip: Any = None
    update_hooks: Optional[List[Any]] = None

    @staticmethod
    def derive(attr, base_default: str, suffix: str):
        """Per-weight attr for multi-parameter layers (stacked_lstm2's
        weights): every field of a caller-supplied attr, with a distinct
        `{base}.{suffix}` name, since passing the attr through unchanged
        would tie the weights into one parameter. attr=None derives from
        `base_default`; attr=False passes through ("no parameter")."""
        if attr is None:
            return ParamAttr(name=f"{base_default}.{suffix}")
        if attr is False:
            return False
        attr = ParamAttr.to_attr(attr)
        base = attr.name or base_default
        return dataclasses.replace(attr, name=f"{base}.{suffix}")

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if arg is False:
            return False  # explicit "no parameter" (e.g. bias_attr=False)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
