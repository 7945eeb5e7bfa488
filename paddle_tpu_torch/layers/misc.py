"""Tensor-manipulation layers (paddle_tpu/layers/misc.py), cut to `crop`
(:108)."""

from __future__ import annotations

from .helper import LayerHelper

__all__ = ["crop"]


def crop(x, offsets, shape):
    """The slice of x of `shape` from `offsets`."""
    helper = LayerHelper("crop")
    out = helper.create_tmp_variable(x.dtype, tuple(shape))
    helper.append_op(type="crop", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"offsets": list(offsets), "shape": list(shape)})
    return out
