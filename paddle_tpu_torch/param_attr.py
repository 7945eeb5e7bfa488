"""ParamAttr: per-parameter configuration (paddle_tpu/param_attr.py):
name, initializer, learning-rate multiplier, regularizer, trainable,
gradient clip and update hooks (Gen-1's ParameterAttribute(update_hooks=),
ParameterUpdaterHook.cpp), consumed by LayerHelper.create_parameter."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional


@dataclass
class StaticPruningHook:
    """Static sparsity kept through the updates
    (ParameterUpdaterHook.cpp:39): a persistable `<param>@PRUNE_MASK`,
    made by the startup program from the initialized weights (the
    smallest `sparsity_ratio` share of |w| zeroed, `prune_mask_init`) and
    applied there at once, then again after every update (`apply_mask`,
    appended to the optimizer's ops)."""

    sparsity_ratio: float = 0.8

    def mask_name(self, param) -> str:
        return f"{param.name}@PRUNE_MASK"

    def append_startup(self, param, main_block, startup_program) -> None:
        """The mask variable and its startup ops, after the parameter's
        initializer."""
        mask = main_block.create_var(self.mask_name(param), tuple(param.shape), param.dtype,
                                     persistable=True)
        sb = startup_program.global_block()
        sb.create_var(mask.name, tuple(param.shape), param.dtype, persistable=True)
        sb.append_op("prune_mask_init", inputs={"Param": [param.name]},
                     outputs={"Out": [mask.name]},
                     attrs={"sparsity_ratio": float(self.sparsity_ratio)})
        sb.append_op("apply_mask", inputs={"Param": [param.name], "Mask": [mask.name]},
                     outputs={"ParamOut": [param.name]})

    def append_update(self, helper, param) -> None:
        mask = helper.main_program.global_block().var(self.mask_name(param))
        helper.append_op(type="apply_mask", inputs={"Param": [param], "Mask": [mask]},
                         outputs={"ParamOut": [param]})


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
