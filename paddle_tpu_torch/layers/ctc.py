"""CTC layers (paddle_tpu/layers/ctc.py): `warpctc`, the loss, and
`ctc_greedy_decoder`, the best-path decode (ops/ctc_ops.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .helper import LayerHelper

__all__ = ["warpctc", "ctc_greedy_decoder"]


def warpctc(input, label, blank: int = 0, norm_by_times: bool = False,
            max_len: Optional[int] = None,
            max_label_len: Optional[int] = None, name=None):
    """CTC loss per sequence [num_seqs, 1] (reference: fluid layers

    warpctc / Gen-1 warp_ctc_layer). `input` — unnormalized frame logits,
    LoD [*, C]; `label` — LoD int tokens excluding `blank`."""
    helper = LayerHelper("warpctc", name=name)
    out = helper.create_tmp_variable(input.dtype, (-1, 1))
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input], "Label": [label]},
        outputs={"Loss": [out]},
        attrs={"blank": blank, "norm_by_times": norm_by_times,
               "max_len": max_len, "max_label_len": max_label_len},
    )
    return out


def ctc_greedy_decoder(input, blank: int = 0,
                       max_len: Optional[int] = None, name=None):
    """Best-path CTC decode (reference: fluid ctc_greedy_decoder /

    ctc_align_op.cc). Returns (ids [num_seqs, T] int32 padded with -1,
    lengths [num_seqs] int32)."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ids = helper.create_tmp_variable(np.int32, (-1, -1))
    lengths = helper.create_tmp_variable(np.int32, (-1,))
    helper.append_op(
        type="ctc_greedy_decoder",
        inputs={"Logits": [input]},
        outputs={"Ids": [ids], "Lengths": [lengths]},
        attrs={"blank": blank, "max_len": max_len},
    )
    return ids, lengths
