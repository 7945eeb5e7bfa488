"""Attention layers (paddle_tpu/layers/attention.py): `multi_head_attention`
(:25-76), the transformer's self-attention, and the NMT decoder's
`attention_gru_decoder` (:100) and `attention_gru_beam_search` (:134),
which share their parameters by name (`_decoder_params`, :81): a beam
program built under the training program's `name` re-binds its weights."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..initializer import XavierInitializer
from ..param_attr import ParamAttr
from .helper import LayerHelper
from .nn import fc

__all__ = ["attention_gru_decoder", "attention_gru_beam_search", "multi_head_attention"]


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


def _decoder_params(helper, ctx_dim, emb_dim, hidden, att_size):
    """Create (or re-bind by name) the decoder's shared parameters."""
    n = helper.name
    xav = XavierInitializer()

    def p(suffix, shape):
        return helper.create_parameter(ParamAttr(name=f"{n}.{suffix}"), shape,
                                       default_initializer=xav)

    return {
        "WaEnc": p("wa_enc", (ctx_dim, att_size)),
        "WaDec": p("wa_dec", (hidden, att_size)),
        "Va": p("va", (att_size,)),
        "Wx": p("wx", (emb_dim + ctx_dim, 3 * hidden)),
        "Wh": p("wh", (hidden, 3 * hidden)),
        "Bias": helper.create_parameter(ParamAttr(name=f"{n}.b"), (3 * hidden,), is_bias=True),
    }


def attention_gru_decoder(enc_state, trg_emb, boot_state, size: int,
                          att_size: Optional[int] = None, src_max_len: Optional[int] = None,
                          trg_max_len: Optional[int] = None, name=None):
    """The teacher-forced attention GRU decoder: one hidden state per
    target token (lod aligned with trg_emb). `size` is the decoder's H,
    enc_state the encoder's [.., C] LoD output, boot_state [B, H]."""
    helper = LayerHelper("att_gru_decoder", name=name)
    ctx_dim, emb_dim = int(enc_state.shape[-1]), int(trg_emb.shape[-1])
    params = _decoder_params(helper, ctx_dim, emb_dim, size, att_size or size)
    out = helper.create_tmp_variable(trg_emb.dtype, (-1, size), lod_level=1)
    helper.append_op(
        type="attention_gru_decoder",
        inputs={"EncState": [enc_state], "TrgEmb": [trg_emb], "H0": [boot_state],
                **{k: [v] for k, v in params.items()}},
        outputs={"Hidden": [out]},
        attrs={"src_max_len": src_max_len, "trg_max_len": trg_max_len})
    return out


def attention_gru_beam_search(enc_state, boot_state, embedding_param, out_w_param, out_b_param,
                              size: int, att_size: Optional[int] = None, beam_size: int = 4,
                              max_len: int = 32, bos_id: int = 0, eos_id: int = 1,
                              src_max_len: Optional[int] = None, length_normalize: bool = False,
                              name=None):
    """Beam search with the decoder named `name` (the training decoder's).
    embedding_param, out_w_param and out_b_param are the target embedding
    [V, E] and the output projection [H, V], [V]: Variables, or names
    declared in this program or held by the global scope. Returns (ids
    [B,K,T] int32, scores [B,K], lengths [B,K] int32)."""
    helper = LayerHelper("att_gru_decoder", name=name)
    ctx_dim = int(enc_state.shape[-1])
    gb = helper.main_program.global_block()

    def as_var(v):
        """A trained parameter by name: this program's, else re-declared
        with the shape the global scope holds."""
        if not isinstance(v, str):
            return v
        if v in gb.vars:
            return gb.vars[v]
        from ..core.executor import global_scope

        scope = global_scope()
        if scope.has(v):
            val = scope.get(v)
            return helper.create_parameter(ParamAttr(name=v), tuple(val.shape),
                                           dtype=np.dtype(str(val.dtype).replace("torch.", "")))
        raise KeyError(f"parameter {v!r} is neither declared in this program nor present in "
                       "the global scope: train it first or pass a Variable")

    emb_v, w_out, b_out = map(as_var, (embedding_param, out_w_param, out_b_param))
    params = _decoder_params(helper, ctx_dim, int(emb_v.shape[-1]), size, att_size or size)
    ids = helper.create_tmp_variable(np.int32, (-1, beam_size, max_len))
    scores = helper.create_tmp_variable(enc_state.dtype, (-1, beam_size))
    lengths = helper.create_tmp_variable(np.int32, (-1, beam_size))
    helper.append_op(
        type="attention_gru_beam_search",
        inputs={"EncState": [enc_state], "H0": [boot_state], "Embedding": [emb_v],
                "WOut": [w_out], "BOut": [b_out], **{k: [v] for k, v in params.items()}},
        outputs={"Ids": [ids], "Scores": [scores], "Lengths": [lengths]},
        attrs={"beam_size": beam_size, "max_len": max_len, "bos_id": bos_id, "eos_id": eos_id,
               "src_max_len": src_max_len, "length_normalize": length_normalize})
    return ids, scores, lengths
