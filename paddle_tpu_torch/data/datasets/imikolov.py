"""PTB language model (paddle_tpu/data/datasets/imikolov.py): `build_dict`
(words with '<unk>', '<s>', '<e>' appended) and readers of n-gram id
tuples (DataType.NGRAM) or whole sentences framed by <s> and <e>
(DataType.SEQ).

ptb.train.txt and ptb.valid.txt are read where they lie under
data_home()/imikolov (words at least `min_word_freq` times, most frequent
first, ties by the word); otherwise the JAX loader's seeded sentences of
5-24 words from an order-1 Markov chain over 2000 words, each word
followed by one of 4 fixed successors.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from . import data_home


class DataType:
    NGRAM = 1
    SEQ = 2


_VOCAB = 2000
_N_TRAIN, _N_TEST = 3000, 300


def _real_file(name):
    p = os.path.join(data_home(), "imikolov", name)
    return p if os.path.exists(p) else None


def build_dict(min_word_freq: int = 50):
    f = _real_file("ptb.train.txt")
    if f:
        cnt = Counter()
        with open(f) as fh:
            for line in fh:
                cnt.update(line.split())
        cnt.pop("<unk>", None)
        words = sorted((w for w, c in cnt.items() if c >= min_word_freq),
                       key=lambda w: (-cnt[w], w))
        d = {w: i for i, w in enumerate(words)}
    else:
        d = {f"w{i}": i for i in range(_VOCAB)}
    d["<unk>"] = len(d)
    d["<s>"] = len(d)
    d["<e>"] = len(d)
    return d


def _sentences(word_idx, n_sent, seed):
    v = max(max(word_idx.values()) - 2, 10)  # <unk>, <s> and <e> left out
    nxt = np.random.RandomState(99).randint(0, v, size=(v, 4))
    rng = np.random.RandomState(seed)
    for _ in range(n_sent):
        length = rng.randint(5, 25)
        w = rng.randint(0, v)
        sent = [w]
        for _ in range(length - 1):
            w = nxt[w, rng.randint(0, 4)]
            sent.append(int(w))
        yield sent


def _reader(word_idx, n, data_type, is_train):
    f = _real_file("ptb.train.txt" if is_train else "ptb.valid.txt")
    s_id, e_id, unk = word_idx["<s>"], word_idx["<e>"], word_idx["<unk>"]

    def sentences():
        if f:
            with open(f) as fh:
                for line in fh:
                    yield [word_idx.get(w, unk) for w in line.split()]
        else:
            yield from _sentences(word_idx, _N_TRAIN if is_train else _N_TEST,
                                  3 if is_train else 4)

    def reader():
        for sent in sentences():
            if data_type == DataType.SEQ:
                yield [s_id] + sent + [e_id]
            else:
                padded = [s_id] * (n - 1) + sent + [e_id]
                for i in range(n, len(padded) + 1):
                    yield tuple(padded[i - n:i])

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, True)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, False)


def convert(path):
    """Recordio shards of both splits (common.convert: not ported yet)."""
    from . import common

    word_dict = build_dict()
    common.convert(path, train(word_dict, 5), 1000, "imikolov_train")
    common.convert(path, test(word_dict, 5), 1000, "imikolov_test")
