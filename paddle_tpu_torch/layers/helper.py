"""LayerHelper (paddle_tpu/layers/helper.py): creates parameters in the
main program's global block with their initializer op in the startup
program (and their ParamAttr's learning-rate multiplier, clip and update
hooks), allocates temporary output variables, appends ops and the
activation a layer's `act` names."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.program import (
    Variable,
    default_main_program,
    default_startup_program,
    unique_name,
)
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name(layer_type)
        self.main_program = kwargs.get("main_program") or default_main_program()
        self.startup_program = kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype=np.float32, is_bias: bool = False,
                         default_initializer=None) -> Variable:
        attr = ParamAttr.to_attr(attr)
        name = attr.name or unique_name(f"{self.name}.w" if not is_bias else f"{self.name}.b")
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        gb = self.main_program.global_block()
        existed = name in gb.vars
        param = gb.create_parameter(name, tuple(shape), dtype, trainable=attr.trainable)
        if existed:
            # a shared parameter (tied weights) is created and initialized once
            if tuple(param.shape) != tuple(shape) or np.dtype(param.dtype) != np.dtype(dtype):
                raise ValueError(
                    f"shared parameter {name!r} re-declared with shape "
                    f"{tuple(shape)}/{np.dtype(dtype).name}, but it already "
                    f"exists as {tuple(param.shape)}/{np.dtype(param.dtype).name}")
            return param
        param.regularizer = attr.regularizer
        param.grad_clip = attr.gradient_clip
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        init(param, self.startup_program)
        if attr.update_hooks:
            # a hook's startup ops (the pruning mask) follow the
            # parameter's initializer; its mask lives in the global block
            param.update_hooks = list(attr.update_hooks)
            for hook in param.update_hooks:
                hook.append_startup(param, gb, self.startup_program)
        return param

    def create_tmp_variable(self, dtype=np.float32, shape=(), lod_level=0) -> Variable:
        return self.block.create_var(unique_name(f"{self.name}.tmp"), shape, dtype,
                                     lod_level=lod_level)

    def append_op(self, **kwargs):
        return self.block.append_op(kwargs["type"], inputs=kwargs.get("inputs"),
                                    outputs=kwargs.get("outputs"), attrs=kwargs.get("attrs"))

    def append_activation(self, out_var: Variable, act: Optional[str], attrs=None):
        if act is None:
            return out_var
        tmp = self.create_tmp_variable(out_var.dtype, out_var.shape, out_var.lod_level)
        self.append_op(type=act, inputs={"X": [out_var]}, outputs={"Out": [tmp]},
                       attrs=attrs or {})
        return tmp
