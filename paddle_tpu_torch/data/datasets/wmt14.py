"""WMT14 fr→en translation (paddle_tpu/data/datasets/wmt14.py; the
reference's python/paddle/v2/dataset/wmt14.py): samples of (src ids,
trg ids <s>-prefixed, trg ids next ending in <e>), the machine_translation
model's three feeds; <s>=0, <e>=1, <unk>=2.

The wmt14.tgz archive is read where it lies under data_home()/wmt14: its
src.dict and trg.dict members (the first dict_size lines) and the
tab-separated parallel lines of train/train and test/test, pairs longer
than 80 dropped (the reference's wmt14.py:53-110). Otherwise the JAX
loader's seeded synthetic pairs: the target is the source reversed through
a fixed permutation of the vocabulary, 3-11 tokens, 3000 train and 300
test pairs. `fetch` downloads nothing (common.download).
"""

from __future__ import annotations

import os
import tarfile

import numpy as np

from . import data_home

START = "<s>"
END = "<e>"
UNK = "<unk>"
START_ID, END_ID, UNK_ID = 0, 1, 2
_RESERVED = 3

_N_TRAIN, _N_TEST = 3000, 300

URL_TRAIN = ("http://paddlepaddle.cdn.bcebos.com/demo/"
             "wmt_shrinked_data/wmt14.tgz")
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"


def _real_tar():
    p = os.path.join(data_home(), "wmt14", "wmt14.tgz")
    return p if os.path.exists(p) else None


def fetch():
    """The cached archive, checksum-verified (common.download)."""
    from .common import download

    return download(URL_TRAIN, "wmt14", MD5_TRAIN)


def _read_real_dict(tar_path, suffix, dict_size):
    with tarfile.open(tar_path) as f:
        names = [m.name for m in f if m.name.endswith(suffix)]
        assert len(names) == 1, (suffix, names)
        out = {}
        for i, line in enumerate(f.extractfile(names[0])):
            if i >= dict_size:
                break
            out[line.strip().decode("utf-8")] = i
        return out


def _real_reader(tar_path, member_suffix, dict_size):
    """Reference: wmt14.py reader_creator — <s>/<e>-wrapped source ids,
    <s>-prefixed target, next-target ending in <e>; drop length>80."""
    # parsed once per reader creator, not once per epoch
    src_dict = _read_real_dict(tar_path, "src.dict", dict_size)
    trg_dict = _read_real_dict(tar_path, "trg.dict", dict_size)

    def reader():
        with tarfile.open(tar_path) as f:
            names = [m.name for m in f if m.name.endswith(member_suffix)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [src_dict.get(w, UNK_ID)
                               for w in [START] + parts[0].split() + [END]]
                    trg_words = [trg_dict.get(w, UNK_ID)
                                 for w in parts[1].split()]
                    if len(src_ids) > 80 or len(trg_words) > 80:
                        continue
                    yield (src_ids, [trg_dict[START]] + trg_words,
                           trg_words + [trg_dict[END]])

    return reader


def _perm(dict_size, seed=17):
    rng = np.random.RandomState(seed)
    content = dict_size - _RESERVED
    return rng.permutation(content)


def _reader(dict_size, n, seed):
    perm = _perm(dict_size)
    content = dict_size - _RESERVED

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = rng.randint(3, 12)
            src = rng.randint(0, content, size=length)
            trg = perm[src[::-1]] + _RESERVED
            src = src + _RESERVED
            trg_in = [START_ID] + trg.tolist()
            trg_next = trg.tolist() + [END_ID]
            yield src.tolist(), trg_in, trg_next

    return reader


def train(dict_size: int):
    tar = _real_tar()
    if tar:
        return _real_reader(tar, "train/train", dict_size)
    return _reader(dict_size, _N_TRAIN, 31)


def test(dict_size: int):
    tar = _real_tar()
    if tar:
        return _real_reader(tar, "test/test", dict_size)
    return _reader(dict_size, _N_TEST, 32)


def get_dict(dict_size: int, reverse: bool = False):
    """Reference API: (src_dict, trg_dict)."""
    tar = _real_tar()
    if tar:
        src = _read_real_dict(tar, "src.dict", dict_size)
        trg = _read_real_dict(tar, "trg.dict", dict_size)
        if reverse:
            src = {v: k for k, v in src.items()}
            trg = {v: k for k, v in trg.items()}
        return src, trg

    def mk():
        d = {START: START_ID, END: END_ID, UNK: UNK_ID}
        for i in range(dict_size - _RESERVED):
            d[f"tok{i}"] = i + _RESERVED
        return {v: k for k, v in d.items()} if reverse else d

    return mk(), mk()


def convert(path):
    """Recordio shards of both splits at dict_size 30000; `common.convert`
    raises until recordio is ported."""
    from . import common

    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
