"""IMDB sentiment (paddle_tpu/data/datasets/imdb.py): samples of
(word ids list[int], label 0/1).

The aclImdb tree is read where it lies under data_home()/imdb: its
train/{pos,neg} reviews give the dictionary (words more frequent than
the cutoff, most frequent first; others map to len(dict)). Otherwise the
JAX loader's seeded synthetic reviews: 8-119 tokens over a vocab of 5147,
positive reviews drawing 80% of their tokens from the first half of it,
negative ones from the second.
"""

from __future__ import annotations

import functools
import glob
import os
import re
from collections import Counter

import numpy as np

from . import data_home

_VOCAB = 5147
_N_TRAIN, _N_TEST = 2000, 400


def _real_dir():
    d = os.path.join(data_home(), "imdb", "aclImdb")
    return d if os.path.isdir(d) else None


def _tokenize(text):
    return re.sub(r"[^a-z0-9 ]", " ", text.lower()).split()


@functools.lru_cache(maxsize=None)
def _real_dict(root, min_freq):
    cnt = Counter()
    for path in glob.glob(os.path.join(root, "train", "*", "*.txt")):
        with open(path, errors="ignore") as f:
            cnt.update(_tokenize(f.read()))
    # strictly above the cutoff, as the reference's build_dict
    return {w: i for i, w in enumerate(w for w, c in cnt.most_common() if c > min_freq)}


def word_dict(min_freq=30):
    """token → id: the real data's dictionary where it lies under
    data_home(), else the synthetic vocab `w0`..`w5146`."""
    root = _real_dir()
    if root:
        return dict(_real_dict(root, min_freq))
    return {f"w{i}": i for i in range(_VOCAB)}


def _real_reader(root, split):
    wd = word_dict()
    unk = len(wd)

    def reader():
        for label, sub in ((1, "pos"), (0, "neg")):
            for path in sorted(glob.glob(os.path.join(root, split, sub, "*.txt"))):
                with open(path, errors="ignore") as f:
                    yield [wd.get(w, unk) for w in _tokenize(f.read())], label

    return reader


def _make(n, seed):
    rng = np.random.RandomState(seed)
    half = _VOCAB // 2
    samples = []
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 120))
        # drawn in the JAX loader's order: the mask, the class's half, the other
        near = rng.rand(length) < 0.8
        if label == 1:
            ids = np.where(near, rng.randint(0, half, length), rng.randint(half, _VOCAB, length))
        else:
            ids = np.where(near, rng.randint(half, _VOCAB, length), rng.randint(0, half, length))
        samples.append((ids.astype(np.int32).tolist(), label))
    return samples


def _reader(split, n, seed):
    root = _real_dir()
    if root:
        return _real_reader(root, split)

    def reader():
        yield from _make(n, seed)

    return reader


def train(word_idx=None):
    return _reader("train", _N_TRAIN, 0)


def test(word_idx=None):
    return _reader("test", _N_TEST, 1)


def convert(path):
    """Recordio shards of both splits (common.convert: not ported yet)."""
    from . import common

    common.convert(path, train(), 1000, "imdb_train")
    common.convert(path, test(), 1000, "imdb_test")
