"""WMT16 en↔de (paddle_tpu/data/datasets/wmt16.py; the reference's
python/paddle/v2/dataset/wmt16.py): wmt14's sample schema and synthetic
mapping over min(src_dict_size, trg_dict_size) tokens, on its own seeds.
"""

from __future__ import annotations

from . import wmt14


def train(src_dict_size: int, trg_dict_size: int, src_lang: str = "en"):
    return wmt14._reader(min(src_dict_size, trg_dict_size), wmt14._N_TRAIN, 41)


def test(src_dict_size: int, trg_dict_size: int, src_lang: str = "en"):
    return wmt14._reader(min(src_dict_size, trg_dict_size), wmt14._N_TEST, 42)


def get_dict(lang: str, dict_size: int, reverse: bool = False):
    d, _ = wmt14.get_dict(dict_size, reverse)
    return d


def convert(path, src_dict_size, trg_dict_size, src_lang="en"):
    """Recordio shards of both splits; `common.convert` raises until
    recordio is ported."""
    from . import common
    common.convert(
        path, train(src_dict_size=src_dict_size,
                    trg_dict_size=trg_dict_size, src_lang=src_lang),
        1000, "wmt16_train")
    common.convert(
        path, test(src_dict_size=src_dict_size,
                   trg_dict_size=trg_dict_size, src_lang=src_lang),
        1000, "wmt16_test")
