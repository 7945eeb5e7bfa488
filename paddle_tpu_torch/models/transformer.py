"""Decoder-only transformer LM (paddle_tpu/models/transformer.py): pre-LN
blocks of causal multi-head attention and a gelu FFN, learned positions
sliced to T by `crop`, built from the layer DSL. In training with
`dropout_prob` each block drops the attention's and the FFN's outputs
before their residual adds.

transformer_lm: tokens [B, T] int32 → logits [B, T, vocab]; the caller's
labels are the inputs shifted left.
"""

from __future__ import annotations

from .. import layers
from ..initializer import NormalInitializer
from ..layers.helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["transformer_lm"]


def _block(x, num_heads, ffn_dim, prefix, dropout_prob):
    """x + drop(MHA(LN(x))); then x + drop(FFN(LN(x))); `dropout_prob` 0
    (or is_test) adds no dropout op."""
    h = layers.layer_norm(x, begin_norm_axis=2, name=f"{prefix}.ln1")
    h = layers.multi_head_attention(h, num_heads=num_heads, causal=True, name=f"{prefix}.attn")
    if dropout_prob:
        h = layers.dropout(h, dropout_prob)
    x = layers.elementwise_add(x, h)
    h = layers.layer_norm(x, begin_norm_axis=2, name=f"{prefix}.ln2")
    h = layers.fc(h, size=ffn_dim, num_flatten_dims=2, act="gelu",
                  param_attr=ParamAttr(name=f"{prefix}.ffn_in"))
    h = layers.fc(h, size=int(x.shape[-1]), num_flatten_dims=2,
                  param_attr=ParamAttr(name=f"{prefix}.ffn_out"))
    if dropout_prob:
        h = layers.dropout(h, dropout_prob)
    return layers.elementwise_add(x, h)


def transformer_lm(tokens, vocab_size: int, dim: int = 512, num_heads: int = 8,
                   num_layers: int = 6, ffn_dim: int = None, max_len: int = 1024,
                   dropout_prob: float = 0.0, is_test: bool = False, mp_axis: str = None,
                   name: str = "tfm"):
    """tokens: a dense [B, T] int32 Variable, T <= max_len. Returns the
    per-position logits [B, T, vocab_size]. Parameter names are the JAX
    package's (`{name}.tok_emb`, `{name}.h{i}.attn.wq`, ...), so its state
    loads here unchanged.

    mp_axis: the mesh axis of Megatron tensor parallelism, as the JAX
    package's (models/transformer.py:56-97): qkv and ffn_in split by output
    features (column), wo and ffn_out by input features (row), the output
    head by vocabulary, each as a `.sharding`; the column-split layers'
    biases are split with them, so a rank adds its own piece.
    parallel.ParallelExecutor over a mesh with that axis runs it (an
    all-reduce after each row-split product)."""
    ffn_dim = ffn_dim or 4 * dim
    T = int(tokens.shape[1])
    if T > max_len:
        raise ValueError(f"sequence length {T} exceeds max_len {max_len}")
    x = layers.embedding(tokens, size=[vocab_size, dim],
                         param_attr=ParamAttr(name=f"{name}.tok_emb"))
    helper = LayerHelper(name)
    pos_table = helper.create_parameter(ParamAttr(name=f"{name}.pos_emb"), (max_len, dim),
                                        default_initializer=NormalInitializer(0.0, 0.01))
    x = layers.elementwise_add(x, layers.crop(pos_table, offsets=(0, 0), shape=(T, dim)))
    for i in range(num_layers):
        x = _block(x, num_heads, ffn_dim, f"{name}.h{i}", 0.0 if is_test else dropout_prob)
    x = layers.layer_norm(x, begin_norm_axis=2, name=f"{name}.ln_f")
    out = layers.fc(x, size=vocab_size, num_flatten_dims=2,
                    param_attr=ParamAttr(name=f"{name}.out_w"), bias_attr=False)
    if mp_axis:
        from ..core.program import default_main_program

        gb = default_main_program().global_block()
        col, row, piece = (None, mp_axis), (mp_axis, None), (mp_axis,)
        for i in range(num_layers):
            p = f"{name}.h{i}"
            for w, spec in ((f"{p}.attn.wq", col), (f"{p}.attn.wk", col),
                            (f"{p}.attn.wv", col), (f"{p}.attn.wo", row),
                            (f"{p}.ffn_in", col), (f"{p}.ffn_out", row)):
                gb.var(w).sharding = spec
            for b in (f"{p}.attn.wq_b", f"{p}.attn.wk_b", f"{p}.attn.wv_b"):
                gb.var(b).sharding = piece
            gb.var(_fc_bias(gb, f"{p}.ffn_in")).sharding = piece
        gb.var(f"{name}.out_w").sharding = col  # vocab-sharded head
    return out


def _fc_bias(gb, weight: str) -> str:
    """The bias an fc added after the product by `weight`."""
    for i, op in enumerate(gb.ops):
        if op.type == "mul" and op.inputs["Y"] == [weight]:
            nxt = gb.ops[i + 1]
            if nxt.type == "elementwise_add" and nxt.inputs["X"] == op.outputs["Out"]:
                return nxt.inputs["Y"][0]
    raise KeyError(f"no bias follows the product by {weight!r}")
