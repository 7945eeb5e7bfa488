"""CRF layers (paddle_tpu/layers/crf.py): `linear_chain_crf` and
`crf_decoding`, the book's label_semantic_roles loss and decoder. The two
share one transition parameter when given the same `param_attr` name;
the decoding op gives it no gradient."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..initializer import UniformInitializer
from .helper import LayerHelper

__all__ = ["linear_chain_crf", "crf_decoding"]


def _transition(helper, input, param_attr):
    """The [D+2, D] transition (row 0 start, row 1 end, rows 2.. the
    transitions), U(-0.1, 0.1), for emissions of D tags."""
    num_tags = int(input.shape[-1])
    return helper.create_parameter(param_attr, (num_tags + 2, num_tags),
                                   default_initializer=UniformInitializer(-0.1, 0.1))


def linear_chain_crf(input, label, param_attr=None, max_len: Optional[int] = None, name=None):
    """The negative log-likelihood of each sequence [num_seqs, 1]; `input`
    the LoD emissions [*, D], `label` the LoD int tags."""
    helper = LayerHelper("linear_chain_crf", name=name)
    transition = _transition(helper, input, param_attr)
    out = helper.create_tmp_variable(input.dtype, (-1, 1))
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Label": [label], "Transition": [transition]},
                     outputs={"LogLikelihood": [out]}, attrs={"max_len": max_len})
    return out


def crf_decoding(input, param_attr=None, label=None, max_len: Optional[int] = None, name=None):
    """The Viterbi path: the LoD int32 best tag of each token, or with
    `label` 1 where it is right and 0 where not."""
    helper = LayerHelper("crf_decoding", name=name)
    transition = _transition(helper, input, param_attr)
    out = helper.create_tmp_variable(np.int32, (-1, 1), lod_level=1)
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs, outputs={"ViterbiPath": [out]},
                     attrs={"max_len": max_len})
    return out
