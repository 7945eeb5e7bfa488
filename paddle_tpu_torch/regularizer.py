"""Weight-decay regularizers (paddle_tpu/regularizer.py): each appends the
ops of grad' = grad + decay_term(param) to the main program, where
Optimizer.minimize marks them as optimizer ops."""

from __future__ import annotations

from dataclasses import dataclass

from .layers.helper import LayerHelper


def _add_scaled(helper, grad, x, coeff):
    scaled = helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [scaled]},
                     attrs={"scale": coeff})
    out = helper.create_tmp_variable(grad.dtype, grad.shape)
    helper.append_op(type="elementwise_add", inputs={"X": [grad], "Y": [scaled]},
                     outputs={"Out": [out]})
    return out


@dataclass
class L2DecayRegularizer:
    """grad + coeff * param."""

    regularization_coeff: float = 0.0

    def append_decay(self, param, grad):
        return _add_scaled(LayerHelper("l2_decay"), grad, param, self.regularization_coeff)


@dataclass
class L1DecayRegularizer:
    """grad + coeff * sign(param)."""

    regularization_coeff: float = 0.0

    def append_decay(self, param, grad):
        helper = LayerHelper("l1_decay")
        sign = helper.create_tmp_variable(param.dtype, param.shape)
        helper.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        return _add_scaled(helper, grad, sign, self.regularization_coeff)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
