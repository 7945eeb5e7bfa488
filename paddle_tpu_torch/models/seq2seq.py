"""Seq2seq with attention (paddle_tpu/models/seq2seq.py), the book's
machine-translation model: a bidirectional GRU encoder and a Bahdanau
attention GRU decoder, trained under teacher forcing by
`seq2seq_attention` and decoded by `seq2seq_beam_decode`.

Training and generation are two programs that share their parameters by
name in the scope: a beam program built with the training program's
`name` prefix re-binds the trained weights.
"""

from __future__ import annotations

from typing import Optional

from .. import layers

__all__ = ["seq2seq_attention", "seq2seq_beam_decode"]


def _encoder(src_words, src_vocab, emb_dim, enc_hidden, src_max_len, prefix):
    """Embedding, a forward and a reverse dynamic_gru over their own [*, 3H]
    projections, their outputs joined to [*, 2H]; and the reverse GRU's
    first step, from which the decoder boots."""
    src_emb = layers.embedding(src_words, size=[src_vocab, emb_dim],
                               param_attr=f"{prefix}.src_emb")
    outs = []
    for d, reverse in (("fwd", False), ("bwd", True)):
        proj = layers.fc(src_emb, size=3 * enc_hidden, bias_attr=False,
                         param_attr=f"{prefix}.enc_{d}_proj")
        outs.append(layers.dynamic_gru(proj, size=enc_hidden, is_reverse=reverse,
                                       max_len=src_max_len, param_attr=f"{prefix}.enc_{d}_w",
                                       bias_attr=f"{prefix}.enc_{d}_b"))
    return layers.sequence_concat(outs), layers.sequence_first_step(outs[1])


def _boot(boot_src, dec_hidden, name):
    return layers.fc(boot_src, size=dec_hidden, act="tanh", param_attr=f"{name}.boot_w",
                     bias_attr=f"{name}.boot_b")


def seq2seq_attention(src_words, trg_words_in, src_vocab: int, trg_vocab: int, emb_dim: int = 32,
                      enc_hidden: int = 32, dec_hidden: int = 32,
                      src_max_len: Optional[int] = None, trg_max_len: Optional[int] = None,
                      name: str = "s2s"):
    """The training net (teacher forcing): per-token logits, lod aligned
    with trg_words_in. Feed trg_words_in = <bos> + target[:-1] and label =
    target (+ <eos>)."""
    enc, boot_src = _encoder(src_words, src_vocab, emb_dim, enc_hidden, src_max_len, name)
    boot = _boot(boot_src, dec_hidden, name)
    trg_emb = layers.embedding(trg_words_in, size=[trg_vocab, emb_dim],
                               param_attr=f"{name}.trg_emb")
    dec_h = layers.attention_gru_decoder(enc, trg_emb, boot, size=dec_hidden,
                                         src_max_len=src_max_len, trg_max_len=trg_max_len,
                                         name=f"{name}.dec")
    return layers.fc(dec_h, size=trg_vocab, param_attr=f"{name}.out_w",
                     bias_attr=f"{name}.out_b")


def seq2seq_beam_decode(src_words, src_vocab: int, trg_vocab: int, emb_dim: int = 32,
                        enc_hidden: int = 32, dec_hidden: int = 32, beam_size: int = 4,
                        max_len: int = 32, bos_id: int = 0, eos_id: int = 1,
                        src_max_len: Optional[int] = None, length_normalize: bool = False,
                        name: str = "s2s"):
    """The generation net: beam search with the weights trained under
    `name`. Returns (ids [B,K,T], scores [B,K], lengths [B,K])."""
    enc, boot_src = _encoder(src_words, src_vocab, emb_dim, enc_hidden, src_max_len, name)
    boot = _boot(boot_src, dec_hidden, name)
    return layers.attention_gru_beam_search(
        enc, boot, f"{name}.trg_emb", f"{name}.out_w", f"{name}.out_b", size=dec_hidden,
        beam_size=beam_size, max_len=max_len, bos_id=bos_id, eos_id=eos_id,
        src_max_len=src_max_len, length_normalize=length_normalize, name=f"{name}.dec")
