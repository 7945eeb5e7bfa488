"""Optimizer front end (paddle_tpu/optimizer/__init__.py): `minimize`
appends the backward (`append_backward`), then per parameter the
regularization, then the gradient clip, then the update op (its learning
rate scaled by the parameter's multiplier) and the parameter's update
hooks, in the JAX package's order, and marks everything after the forward
as optimizer ops. The parameters of is_sparse embeddings (SelectedRows
gradients) skip the regularization and the clips, as the JAX package's
do. State (moments, beta powers, the learning rate or a schedule's step)
lives in persistable variables that the startup program fills, named
`{optimizer}.{accumulator}.{parameter}` as the JAX package names them, so
a checkpoint crosses between the packages.

The nine optimizers, the five learning-rate schedules (computed on the
device from the step, `lr_schedule`), the per-value, per-norm and
global-norm clips, and ModelAverage."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.backward import append_backward
from ..core.program import (Variable, default_main_program, default_startup_program,
                            unique_name)
from ..initializer import ConstantInitializer
from ..layers.helper import LayerHelper

__all__ = ["SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp", "DecayedAdagrad", "Adam",
           "Adamax", "Ftrl", "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
           "AdadeltaOptimizer", "RMSPropOptimizer", "DecayedAdagradOptimizer", "AdamOptimizer",
           "AdamaxOptimizer", "FtrlOptimizer", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "PiecewiseDecay", "ModelAverage"]


# ---------------------------------------------------------- LR schedules ---
class LRSchedule:
    """A learning rate from the step counter (Gen-1 LearningRateScheduler
    policies, Fluid's lr decay): `schedule(step, base_lr)` with torch
    operations on the f32 0-d step, on its device."""

    def __call__(self, step, base_lr):
        raise NotImplementedError


class _StepDecay(LRSchedule):
    def __init__(self, decay_steps, decay_rate, staircase=False):
        self.decay_steps, self.decay_rate, self.staircase = decay_steps, decay_rate, staircase

    def _progress(self, step):
        p = step / self.decay_steps
        return torch.floor(p) if self.staircase else p


class ExponentialDecay(_StepDecay):
    """base_lr · decay_rate^(step / decay_steps)."""

    def __call__(self, step, base_lr):
        return base_lr * torch.pow(self.decay_rate, self._progress(step))


class NaturalExpDecay(_StepDecay):
    """base_lr · exp(-decay_rate · step / decay_steps)."""

    def __call__(self, step, base_lr):
        return base_lr * torch.exp(-self.decay_rate * self._progress(step))


class InverseTimeDecay(_StepDecay):
    """base_lr / (1 + decay_rate · step / decay_steps)."""

    def __call__(self, step, base_lr):
        return base_lr / (1.0 + self.decay_rate * self._progress(step))


class PolynomialDecay(LRSchedule):
    """(base_lr - end) · (1 - step / decay_steps)^power + end, the step
    held at decay_steps, or with `cycle` decay_steps stretched to the next
    multiple past the step."""

    def __init__(self, decay_steps, end_learning_rate=1e-4, power=1.0, cycle=False):
        self.decay_steps = decay_steps
        self.end_lr = end_learning_rate
        self.power = power
        self.cycle = cycle

    def __call__(self, step, base_lr):
        if self.cycle:
            decay_steps = torch.clamp(torch.ceil(step / self.decay_steps), min=1.0) \
                * self.decay_steps
        else:
            decay_steps = self.decay_steps
            step = torch.clamp(step, max=decay_steps)
        frac = torch.pow(1.0 - step / decay_steps, self.power)
        return (base_lr - self.end_lr) * frac + self.end_lr


class PiecewiseDecay(LRSchedule):
    """values[i] while the step is below boundaries[i], values[-1] after."""

    def __init__(self, boundaries: Sequence[int], values: Sequence[float]):
        if len(values) != len(boundaries) + 1:
            raise ValueError("PiecewiseDecay needs one value more than boundaries")
        self.boundaries, self.values = list(boundaries), list(values)

    def __call__(self, step, base_lr):
        lr = torch.full((), self.values[-1], dtype=torch.float32, device=step.device)
        for b, v in zip(reversed(self.boundaries), reversed(self.values[:-1])):
            lr = torch.where(step < b, v, lr)
        return lr


# ------------------------------------------------------ gradient clipping --
class GradientClipByValue:
    """Each gradient element clamped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def apply_one(self, helper, param, grad):
        out = helper.create_tmp_variable(grad.dtype, grad.shape)
        helper.append_op(type="clip", inputs={"X": [grad]}, outputs={"Out": [out]},
                         attrs={"min": self.min, "max": self.max})
        return out


class GradientClipByNorm:
    """Each gradient scaled to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply_one(self, helper, param, grad):
        out = helper.create_tmp_variable(grad.dtype, grad.shape)
        helper.append_op(type="clip_by_norm", inputs={"X": [grad]}, outputs={"Out": [out]},
                         attrs={"max_norm": self.clip_norm})
        return out


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
                 lr_schedule: Optional[LRSchedule] = None, name=None):
        self.base_lr = learning_rate
        self.regularization = regularization
        self.grad_clip = grad_clip
        self.lr_schedule = lr_schedule
        self.name = name or unique_name(self.op_type or "opt")
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    def _add_accumulator(self, helper, name, param, fill=0.0, shape=None):
        acc = helper.main_program.global_block().create_var(
            f"{self.name}.{name}.{param.name}",
            tuple(shape if shape is not None else param.shape), param.dtype,
            persistable=True)
        acc.is_optimizer_state = True
        # a same-shaped accumulator of a param with a placement (mp_axis, a
        # sharded embedding) takes it, as the JAX package's does
        if param.sharding is not None and tuple(acc.shape) == tuple(param.shape):
            acc.sharding = param.sharding
        ConstantInitializer(fill)(acc, helper.startup_program)
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _lr_var(self, helper) -> Variable:
        """The learning rate: a persistable, or under a schedule the
        schedule of a persistable step counter, incremented each step."""
        block = helper.main_program.global_block()
        if self.lr_schedule is not None:
            step = block.create_var(f"{self.name}.step", (), np.float32, persistable=True)
            ConstantInitializer(0.0)(step, helper.startup_program)
            helper.append_op(type="increment", inputs={"X": [step]}, outputs={"Out": [step]},
                             attrs={"step": 1.0})
            lr = helper.create_tmp_variable(np.float32, ())
            helper.append_op(type="lr_schedule", inputs={"Step": [step]}, outputs={"Out": [lr]},
                             attrs={"schedule": self.lr_schedule, "base_lr": self.base_lr})
            return lr
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
        # a decay or a clip over a whole sparse table would make its
        # SelectedRows gradient dense: sparse_update parameters skip both
        params_grads = [
            (p, g if p.sparse_update or (p.regularizer or self.regularization) is None
             else (p.regularizer or self.regularization).append_decay(p, g))
            for p, g in params_grads]
        if isinstance(self.grad_clip, GradientClipByGlobalNorm):
            params_grads = (self.grad_clip.apply_all(
                helper, [pg for pg in params_grads if not pg[0].sparse_update])
                + [pg for pg in params_grads if pg[0].sparse_update])
        elif self.grad_clip is not None:
            params_grads = [(p, g if p.sparse_update else self.grad_clip.apply_one(helper, p, g))
                            for p, g in params_grads]
        else:
            clipped = []
            for p, g in params_grads:
                if p.grad_clip is not None and not p.sparse_update:
                    if isinstance(p.grad_clip, GradientClipByGlobalNorm):
                        raise ValueError("per-param global-norm clip unsupported; set it on "
                                         "the optimizer")
                    g = p.grad_clip.apply_one(helper, p, g)
                clipped.append((p, g))
            params_grads = clipped
        lr = self._lr_var(helper)
        self._create_accumulators(helper, [p for p, _ in params_grads])
        for p, g in params_grads:
            plr = lr
            mult = p.optimize_attr.get("learning_rate", 1.0)
            if mult != 1.0:
                plr = helper.create_tmp_variable(np.float32, ())
                helper.append_op(type="scale", inputs={"X": [lr]}, outputs={"Out": [plr]},
                                 attrs={"scale": mult})
            self._append_update_op(helper, p, g, plr)
            # after the update, so that masked weights stay masked
            for hook in p.update_hooks or []:
                hook.append_update(helper, p)
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


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"

    def __init__(self, learning_rate=0.001, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "moment", p)

    def _append_update_op(self, helper, param, grad, lr):
        m = self._accumulators["moment"][param.name]
        helper.append_op(type="adagrad",
                         inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                                 "LearningRate": [lr]},
                         outputs={"ParamOut": [param], "MomentOut": [m]},
                         attrs={"epsilon": self.epsilon})


class AdadeltaOptimizer(Optimizer):
    op_type = "adadelta"

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "avg_squared_grad", p)
            self._add_accumulator(helper, "avg_squared_update", p)

    def _append_update_op(self, helper, param, grad, lr):
        a = self._accumulators
        helper.append_op(type="adadelta",
                         inputs={"Param": [param], "Grad": [grad],
                                 "AvgSquaredGrad": [a["avg_squared_grad"][param.name]],
                                 "AvgSquaredUpdate": [a["avg_squared_update"][param.name]],
                                 "LearningRate": [lr]},
                         outputs={"ParamOut": [param]},
                         attrs={"rho": self.rho, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    op_type = "rmsprop"

    def __init__(self, learning_rate=0.001, decay=0.95, momentum=0.0, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "mean_square", p)
            self._add_accumulator(helper, "moment", p)

    def _append_update_op(self, helper, param, grad, lr):
        a = self._accumulators
        helper.append_op(type="rmsprop",
                         inputs={"Param": [param], "Grad": [grad],
                                 "MeanSquare": [a["mean_square"][param.name]],
                                 "Moment": [a["moment"][param.name]], "LearningRate": [lr]},
                         outputs={"ParamOut": [param]},
                         attrs={"decay": self.decay, "momentum": self.momentum,
                                "epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    op_type = "decayed_adagrad"

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "moment", p)

    def _append_update_op(self, helper, param, grad, lr):
        m = self._accumulators["moment"][param.name]
        helper.append_op(type="decayed_adagrad",
                         inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                                 "LearningRate": [lr]},
                         outputs={"ParamOut": [param]},
                         attrs={"decay": self.decay, "epsilon": self.epsilon})


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


class AdamaxOptimizer(Optimizer):
    op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "moment", p)
            self._add_accumulator(helper, "inf_norm", p)
            self._add_accumulator(helper, "beta1_pow", p, fill=self.beta1, shape=())

    def _append_update_op(self, helper, param, grad, lr):
        a = self._accumulators
        helper.append_op(type="adamax",
                         inputs={"Param": [param], "Grad": [grad], "LearningRate": [lr],
                                 "Moment": [a["moment"][param.name]],
                                 "InfNorm": [a["inf_norm"][param.name]],
                                 "Beta1Pow": [a["beta1_pow"][param.name]]},
                         outputs={"ParamOut": [param]},
                         attrs={"beta1": self.beta1, "beta2": self.beta2,
                                "epsilon": self.epsilon})


class FtrlOptimizer(Optimizer):
    op_type = "ftrl"

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _create_accumulators(self, helper, params):
        for p in params:
            self._add_accumulator(helper, "squared", p)
            self._add_accumulator(helper, "linear", p)

    def _append_update_op(self, helper, param, grad, lr):
        a = self._accumulators
        helper.append_op(type="ftrl",
                         inputs={"Param": [param], "Grad": [grad], "LearningRate": [lr],
                                 "SquaredAccumulator": [a["squared"][param.name]],
                                 "LinearAccumulator": [a["linear"][param.name]]},
                         outputs={"ParamOut": [param]},
                         attrs={"l1": self.l1, "l2": self.l2, "lr_power": self.lr_power})


# -------------------------------------------------------- model averaging --
class ModelAverage:
    """Parameter averaging over a sliding window (AverageOptimizer.h, v1's
    ModelAverage): an `average_accumulate` op a parameter keeps a sum that
    restarts once the count passes clamp(average_window_rate · updates,
    min_average_window, max_average_window). `apply()` puts the averages
    into the scope, `restore()` the trained values back (for an eval)."""

    def __init__(self, average_window_rate: float = 0.15, min_average_window: int = 10000,
                 max_average_window: int = 10**9, program=None):
        self.program = program or default_main_program()
        helper = LayerHelper("model_average", main_program=self.program)
        attrs = {"average_window": average_window_rate,
                 "min_average_window": min_average_window,
                 "max_average_window": max_average_window}
        gb = self.program.global_block()
        self.pairs = []
        for p in self.program.parameters():
            s = gb.create_var(f"@AVG@.{p.name}", p.shape, p.dtype, persistable=True)
            n = gb.create_var(f"@AVG_N@.{p.name}", (), np.float32, persistable=True)
            t = gb.create_var(f"@AVG_T@.{p.name}", (), np.float32, persistable=True)
            for v in (s, n, t):
                ConstantInitializer(0.0)(v, helper.startup_program)
            helper.append_op(type="average_accumulate",
                             inputs={"Param": [p], "Sum": [s], "Count": [n], "Total": [t]},
                             outputs={}, attrs=attrs)
            self.pairs.append((p, s, n))

    def apply(self, executor=None, scope=None):
        """Each parameter's average (sum / max(count, 1)) into the scope, on
        the parameter's device; the trained values kept for `restore`."""
        from ..core.executor import global_scope

        scope = scope or global_scope()
        self._backup = {}
        for p, s, n in self.pairs:
            self._backup[p.name] = scope.get(p.name)
            scope.set(p.name, scope.get(s.name) / torch.clamp(scope.get(n.name), min=1.0))

    def restore(self, executor=None, scope=None):
        from ..core.executor import global_scope

        scope = scope or global_scope()
        for name, val in self._backup.items():
            scope.set(name, val)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Ftrl = FtrlOptimizer
