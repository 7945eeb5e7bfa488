"""Tensor-manipulation layers (paddle_tpu/layers/misc.py), cut to `crop`
(:108) and `cos_sim` (:143)."""

from __future__ import annotations

from .helper import LayerHelper

__all__ = ["crop", "cos_sim"]


def crop(x, offsets, shape):
    """The slice of x of `shape` from `offsets`."""
    helper = LayerHelper("crop")
    out = helper.create_tmp_variable(x.dtype, tuple(shape))
    helper.append_op(type="crop", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"offsets": list(offsets), "shape": list(shape)})
    return out


def cos_sim(x, y, scale=1.0):
    """scale · cos(x, y) of each row: [N, 1]."""
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(x.dtype, (x.shape[0], 1), lod_level=x.lod_level)
    helper.append_op(type="cos_sim", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"scale": scale})
    return out
