"""Attention layers (paddle_tpu/layers/attention.py), cut to
`multi_head_attention` (:25-76), the transformer's self-attention."""

from __future__ import annotations

from ..param_attr import ParamAttr
from .helper import LayerHelper
from .nn import fc

__all__ = ["multi_head_attention"]


def multi_head_attention(query, key=None, value=None, num_heads: int = 8, causal: bool = True,
                         param_attr=None, bias_attr=None, name=None):
    """Multi-head attention over dense [B, T, E] inputs (self-attention when
    key and value are None): the Q, K, V and output projections are `fc`
    layers, each with its own `{name}.w{q,k,v,o}` weight and `_b` bias
    (ParamAttr.derive); the `flash_attention` op between them splits E into
    num_heads heads."""
    is_cross = key is not None or value is not None
    if is_cross and causal:
        raise ValueError("causal=True is only valid for self-attention; pass "
                         "causal=False for cross-attention")
    key = query if key is None else key
    value = query if value is None else value
    helper = LayerHelper("multi_head_attention", name=name)
    E = int(query.shape[-1])
    if E % num_heads:
        raise ValueError(f"hidden dim {E} not divisible by {num_heads} heads")

    def proj(x, s):
        return fc(x, size=E, num_flatten_dims=2,
                  param_attr=ParamAttr.derive(param_attr, helper.name, s),
                  bias_attr=ParamAttr.derive(bias_attr, helper.name, f"{s}_b"))

    q, k, v = proj(query, "wq"), proj(key, "wk"), proj(value, "wv")
    out = helper.create_tmp_variable(query.dtype, query.shape)
    helper.append_op(type="flash_attention", inputs={"Q": [q], "K": [k], "V": [v]},
                     outputs={"Out": [out]}, attrs={"num_heads": num_heads, "causal": causal})
    return proj(out, "wo")
