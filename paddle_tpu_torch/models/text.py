"""Text models (paddle_tpu/models/text.py), cut to the RNN benchmark:
benchmark/paddle/rnn/rnn.py's 2x stacked LSTM text classifier on IMDB,
the reference's headline LSTM benchmark."""

from __future__ import annotations

from .. import layers


def lstm_benchmark_net(words, vocab_size, emb_dim=128, hidden=512, class_dim=2,
                       max_len=None, sharded_embedding_axis=None):
    """embedding → fc to 4H (no bias) → stacked_lstm2 (two layers) → the
    last step of each sequence → fc to the classes. `max_len` bounds the
    time steps run (None: the LoD capacity)."""
    if sharded_embedding_axis:
        raise NotImplementedError("the vocab-sharded embedding is not ported to the "
                                  "PyTorch port yet")
    emb = layers.embedding(words, size=[vocab_size, emb_dim])
    proj1 = layers.fc(emb, size=hidden * 4, bias_attr=False)
    lstm2 = layers.stacked_lstm2(proj1, size=hidden * 4, max_len=max_len)
    pooled = layers.sequence_pool(lstm2, "last")
    return layers.fc(pooled, size=class_dim)
