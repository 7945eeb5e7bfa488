"""CoNLL-2005 semantic role labelling (paddle_tpu/data/datasets/conll05.py;
the reference's python/paddle/v2/dataset/conll05.py), synthetic only, as
in the JAX package: the same seeded samples.

A sample is 9 sequences for one (sentence, predicate) pair: (word ids,
ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate ids, mark, label ids),
the feeds of the book's label_semantic_roles model. `get_dict()` gives
(word_dict, verb_dict, label_dict): 3001 words (with <unk>), 50 verbs and
9 IOB labels (B-/I- for 4 role types, then O). Each sentence of 6-19
words has one predicate; a role span left of it is A0 or A1 and one right
of it A2 or A3, the types keyed to the predicate. 1500 train and 200 test
sentences.
"""

from __future__ import annotations

import numpy as np

_WORD_VOCAB = 3000
_N_VERBS = 50
_N_ROLES = 4  # role types → labels B-Ai/I-Ai per type + O
_N_TRAIN, _N_TEST = 1500, 200


def word_dict():
    d = {f"w{i}": i for i in range(_WORD_VOCAB)}
    d["<unk>"] = len(d)
    return d


def verb_dict():
    return {f"v{i}": i for i in range(_N_VERBS)}


def label_dict():
    # IOB layout: B-A0=0, I-A0=1, B-A1=2, I-A1=3, ... O=2*_N_ROLES
    d = {}
    for t in range(_N_ROLES):
        d[f"B-A{t}"] = 2 * t
        d[f"I-A{t}"] = 2 * t + 1
    d["O"] = 2 * _N_ROLES
    return d


def get_dict():
    return word_dict(), verb_dict(), label_dict()


def get_embedding():
    """Reference ships a pretrained emb matrix; here a fixed random one."""
    rng = np.random.RandomState(5)
    return rng.randn(_WORD_VOCAB + 1, 32).astype(np.float32)


def _ctx(words, pred_pos, off):
    """Predicate-context word at pred_pos+off, broadcast over the sequence
    (reference conll05: ctx_n2..ctx_p2 are constant per (sentence, verb))."""
    j = min(max(pred_pos + off, 0), len(words) - 1)
    return words[j]


def _reader(n, seed):
    o_tag = 2 * _N_ROLES

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = rng.randint(6, 20)
            words = rng.randint(0, _WORD_VOCAB, size=length).tolist()
            pred_pos = rng.randint(1, length - 1)
            verb = words[pred_pos] % _N_VERBS
            labels = [o_tag] * length
            # role span left of the predicate; type from word id parity
            lstart = max(0, pred_pos - 3)
            t0 = verb % 2  # A0 or A1 — keyed to the predicate so the
            labels[lstart] = 2 * t0  # mapping generalizes to unseen words
            for k in range(lstart + 1, pred_pos):
                labels[k] = 2 * t0 + 1
            # role span right of the predicate
            rend = min(length, pred_pos + 1 + rng.randint(1, 4))
            t1 = 2 + (verb >> 1) % 2  # A2 or A3
            labels[pred_pos + 1] = 2 * t1
            for k in range(pred_pos + 2, rend):
                labels[k] = 2 * t1 + 1
            mark = [1 if k == pred_pos else 0 for k in range(length)]
            preds = [verb] * length
            yield (
                words,
                [_ctx(words, pred_pos, -2)] * length,
                [_ctx(words, pred_pos, -1)] * length,
                [_ctx(words, pred_pos, 0)] * length,
                [_ctx(words, pred_pos, 1)] * length,
                [_ctx(words, pred_pos, 2)] * length,
                preds,
                mark,
                labels,
            )

    return reader


def train():
    return _reader(_N_TRAIN, 21)


def test():
    return _reader(_N_TEST, 22)


def convert(path):
    """Recordio shards of train() and test(); `common.convert` raises until
    recordio is ported."""
    from . import common

    common.convert(path, train(), 1000, "conll05_train")
    common.convert(path, test(), 1000, "conll05_test")
