"""Optimizer front end (paddle_tpu/optimizer/__init__.py): `minimize`
appends the backward (`append_backward`), then per parameter the
regularization, then the gradient clip, then the update op, in the JAX
package's order, and marks everything after the forward as optimizer ops.
State (moments, beta powers, the learning rate) lives in persistable
variables that the startup program fills.

Cut to SGD, Momentum, Adam and GradientClipByGlobalNorm; the other optimizers, the
per-value and per-norm clips and learning-rate schedules are not ported
yet and raise."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.backward import append_backward
from ..core.program import Variable, default_startup_program, unique_name
from ..initializer import ConstantInitializer
from ..layers.helper import LayerHelper

__all__ = ["SGD", "Momentum", "Adam", "SGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
           "GradientClipByGlobalNorm"]


class GradientClipByGlobalNorm:
    """Scales every gradient by min(clip_norm / global_norm, 1), the
    global norm taken over all of them (one clip_by_global_norm op)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply_all(self, helper, params_grads):
        grads = [g for _, g in params_grads]
        outs = [helper.create_tmp_variable(g.dtype, g.shape) for g in grads]
        helper.append_op(type="clip_by_global_norm", inputs={"X": grads},
                         outputs={"Out": outs}, attrs={"max_global_norm": self.clip_norm})
        return [(p, o) for (p, _), o in zip(params_grads, outs)]


class Optimizer:
    op_type: str = ""

    def __init__(self, learning_rate: float = 0.001, regularization=None, grad_clip=None,
                 lr_schedule=None, name=None):
        if lr_schedule is not None:
            raise NotImplementedError("learning-rate schedules are not ported to the "
                                      "PyTorch port yet")
        if grad_clip is not None and not isinstance(grad_clip, GradientClipByGlobalNorm):
            raise NotImplementedError(f"{type(grad_clip).__name__} is not ported to the "
                                      "PyTorch port yet")
        self.base_lr = learning_rate
        self.regularization = regularization
        self.grad_clip = grad_clip
        self.name = name or unique_name(self.op_type or "opt")
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    def _add_accumulator(self, helper, name, param, fill=0.0, shape=None):
        acc = helper.main_program.global_block().create_var(
            f"{self.name}.{name}.{param.name}",
            tuple(shape if shape is not None else param.shape), param.dtype,
            persistable=True)
        ConstantInitializer(fill)(acc, helper.startup_program)
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _lr_var(self, helper) -> Variable:
        block = helper.main_program.global_block()
        lr = block.create_var(f"{self.name}.lr", (), np.float32, persistable=True)
        ConstantInitializer(self.base_lr)(lr, helper.startup_program)
        return lr

    def _create_accumulators(self, helper, params):
        pass

    def _append_update_op(self, helper, param, grad, lr):
        raise NotImplementedError

    def minimize(self, loss: Variable, startup_program=None, parameter_list=None,
                 no_grad_set=None) -> List[Tuple[Variable, Variable]]:
        helper = LayerHelper(self.name, main_program=loss.block.program,
                             startup_program=startup_program or default_startup_program())
        block = loss.block.program.global_block()
        opt_pass_start = len(block.ops)
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        sparse = [p.name for p, _ in params_grads if p.sparse_update]
        if sparse and (self.grad_clip is not None or self.regularization is not None
                       or any(p.regularizer for p, _ in params_grads)):
            raise NotImplementedError(
                f"{sparse}: SelectedRows gradients (is_sparse embeddings), which "
                "skip regularization and clipping, are not ported yet")
        params_grads = [
            (p, g if (p.regularizer or self.regularization) is None
             else (p.regularizer or self.regularization).append_decay(p, g))
            for p, g in params_grads]
        if self.grad_clip is not None:
            params_grads = self.grad_clip.apply_all(helper, params_grads)
        elif any(p.grad_clip is not None for p, _ in params_grads):
            raise NotImplementedError("per-parameter gradient clips are not ported to the "
                                      "PyTorch port yet")
        lr = self._lr_var(helper)
        self._create_accumulators(helper, [p for p, _ in params_grads])
        for p, g in params_grads:
            self._append_update_op(helper, p, g, lr)
        # the backward and update slice, as the JAX package marks it
        for op in block.ops[opt_pass_start:]:
            op.attrs["is_optimizer_op"] = True
        return params_grads


class SGDOptimizer(Optimizer):
    op_type = "sgd"

    def _append_update_op(self, helper, param, grad, lr):
        helper.append_op(type="sgd",
                         inputs={"Param": [param], "Grad": [grad], "LearningRate": [lr]},
                         outputs={"ParamOut": [param]})


class MomentumOptimizer(Optimizer):
    op_type = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum, self.use_nesterov = momentum, use_nesterov

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "velocity", p)

    def _append_update_op(self, helper, param, grad, lr):
        v = self._accumulators["velocity"][param.name]
        helper.append_op(type="momentum",
                         inputs={"Param": [param], "Grad": [grad], "Velocity": [v],
                                 "LearningRate": [lr]},
                         outputs={"ParamOut": [param], "VelocityOut": [v]},
                         attrs={"mu": self.momentum, "use_nesterov": self.use_nesterov})


class AdamOptimizer(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "moment1", p)
            self._add_accumulator(helper, "moment2", p)
            self._add_accumulator(helper, "beta1_pow", p, fill=self.beta1, shape=())
            self._add_accumulator(helper, "beta2_pow", p, fill=self.beta2, shape=())

    def _append_update_op(self, helper, param, grad, lr):
        a = self._accumulators
        helper.append_op(
            type="adam",
            inputs={"Param": [param], "Grad": [grad], "LearningRate": [lr],
                    "Moment1": [a["moment1"][param.name]],
                    "Moment2": [a["moment2"][param.name]],
                    "Beta1Pow": [a["beta1_pow"][param.name]],
                    "Beta2Pow": [a["beta2_pow"][param.name]]},
            outputs={"ParamOut": [param]},
            attrs={"beta1": self.beta1, "beta2": self.beta2, "epsilon": self.epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
