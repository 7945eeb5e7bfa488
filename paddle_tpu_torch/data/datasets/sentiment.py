"""Movie-review sentiment (paddle_tpu/data/datasets/sentiment.py; the
reference's python/paddle/v2/dataset/sentiment.py, NLTK's movie_reviews),
synthetic only, as in the JAX package: samples of (word ids, label 0/1),
10-59 tokens over a vocab of 2000, a review of label 1 drawing 3 of 4
tokens from the first half of it, of label 0 from the second; 1600 train
and 400 test reviews.
"""

from __future__ import annotations

import numpy as np

_VOCAB = 2000
_N_TRAIN, _N_TEST = 1600, 400


def get_word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        half = _VOCAB // 2
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = rng.randint(10, 60)
            # positive docs over-sample the first vocab half 3:1
            biased = rng.rand(length) < 0.75
            ids = np.where(
                biased == (label == 0),
                rng.randint(0, half, size=length),
                rng.randint(half, _VOCAB, size=length),
            )
            yield ids.tolist(), label

    return reader


def train():
    return _reader(_N_TRAIN, 51)


def test():
    return _reader(_N_TEST, 52)


def convert(path):
    """Recordio shards of both splits; `common.convert` raises until
    recordio is ported."""
    from . import common
    common.convert(path, train, 1000, "sentiment_train")
    common.convert(path, test, 1000, "sentiment_test")
