"""Text models (paddle_tpu/models/text.py): benchmark/paddle/rnn/rnn.py's
2x stacked LSTM text classifier on IMDB, the reference's headline LSTM
benchmark, and the book's understand_sentiment stacked_lstm_net and
word2vec N-gram model."""

from __future__ import annotations

from .. import layers


def lstm_benchmark_net(words, vocab_size, emb_dim=128, hidden=512, class_dim=2,
                       max_len=None, sharded_embedding_axis=None):
    """embedding → fc to 4H (no bias) → stacked_lstm2 (two layers) → the
    last step of each sequence → fc to the classes. `max_len` bounds the
    time steps run (None: the LoD capacity). `sharded_embedding_axis`
    stripes the table's rows over that mesh axis
    (parallel/sharded_embedding.py)."""
    if sharded_embedding_axis:
        from ..parallel.sharded_embedding import sharded_embedding

        emb = sharded_embedding(words, size=[vocab_size, emb_dim],
                                mesh_axis=sharded_embedding_axis)
    else:
        emb = layers.embedding(words, size=[vocab_size, emb_dim])
    proj1 = layers.fc(emb, size=hidden * 4, bias_attr=False)
    lstm2 = layers.stacked_lstm2(proj1, size=hidden * 4, max_len=max_len)
    pooled = layers.sequence_pool(lstm2, "last")
    return layers.fc(pooled, size=class_dim)


def stacked_lstm_net(words, vocab_size, emb_dim=128, hid_dim=128, stacked_num=3, class_dim=2,
                     max_len=None, use_stacked_op=False):
    """The book's understand_sentiment stacked_lstm_net: embedding → fc to
    4H → `stacked_num` LSTM layers, each after the first fed
    fc([fc_prev, lstm_prev]) → both streams max-pooled → fc to the
    classes. `use_stacked_op` builds the stack as the one `stacked_lstm`
    op instead of the per-layer fc + dynamic_lstm layers."""
    emb = layers.embedding(words, size=[vocab_size, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim * 4)
    if use_stacked_op:
        fc_seq, lstm_seq = layers.stacked_lstm(fc1, size=hid_dim * 4, stacked_num=stacked_num,
                                               max_len=max_len)
    else:
        fc_seq = fc1
        lstm_seq = layers.dynamic_lstm(fc1, size=hid_dim * 4, max_len=max_len)
        for _ in range(2, stacked_num + 1):
            fc_seq = layers.fc([fc_seq, lstm_seq], size=hid_dim * 4)
            lstm_seq = layers.dynamic_lstm(fc_seq, size=hid_dim * 4, max_len=max_len)
    fc_last = layers.sequence_pool(fc_seq, "max")
    lstm_last = layers.sequence_pool(lstm_seq, "max")
    return layers.fc([fc_last, lstm_last], size=class_dim)


def word2vec_net(words_list, dict_size, emb_dim=32):
    """The book's word2vec N-gram model: the context words' embeddings
    from one shared table `shared_emb_w`, joined → fc 256 sigmoid → fc
    over the dictionary. `words_list`: dense int variables."""
    embs = [layers.embedding(w, size=[dict_size, emb_dim], param_attr="shared_emb_w")
            for w in words_list]
    hidden = layers.fc(layers.concat(embs, axis=1), size=256, act="sigmoid")
    return layers.fc(hidden, size=dict_size)
