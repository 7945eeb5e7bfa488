"""UCI housing (paddle_tpu/data/datasets/uci_housing.py): samples of
(features[13] float32, price[1] float32).

The real `housing.data` (14 whitespace-separated columns) is read where it
lies under data_home()/uci_housing, each feature scaled to (x − mean) /
(max − min) and the first 80% of rows the training split; otherwise the
JAX loader's seeded synthetic data (a fixed linear model plus noise).
"""

from __future__ import annotations

import os

import numpy as np

from . import data_home

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
                 "PTRATIO", "B", "LSTAT"]

_N_TRAIN, _N_TEST = 404, 102

URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"
MD5 = "d4accdce7a25600298819f8e28e8d593"


def fetch():
    """The cached housing.data (common.download: nothing is fetched)."""
    from .common import download

    return download(URL, "uci_housing", MD5)


def _real_file():
    p = os.path.join(data_home(), "uci_housing", "housing.data")
    return p if os.path.exists(p) else None


def _load_real(filename, feature_num=14, ratio=0.8):
    data = np.fromfile(filename, sep=" ")
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maxs, mins, avgs = data.max(axis=0), data.min(axis=0), data.mean(axis=0)
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
    offset = int(data.shape[0] * ratio)
    return data[:offset].astype(np.float32), data[offset:].astype(np.float32)


def _make(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 13).astype(np.float32)
    w = np.linspace(-1.5, 1.5, 13).astype(np.float32)[:, None]
    y = x @ w + 0.3 + 0.1 * rng.randn(n, 1).astype(np.float32)
    return x, y.astype(np.float32)


def _reader(is_train):
    def reader():
        f = _real_file()
        if f:
            tr, te = _load_real(f)
            for row in (tr if is_train else te):
                yield row[:-1], row[-1:]
            return
        x, y = _make(_N_TRAIN if is_train else _N_TEST, seed=0 if is_train else 1)
        for i in range(x.shape[0]):
            yield x[i], y[i]

    return reader


def train():
    return _reader(True)


def test():
    return _reader(False)


def convert(path):
    """Recordio shards of both splits (common.convert: not ported yet)."""
    from . import common

    common.convert(path, train(), 1000, "uci_housing_train")
    common.convert(path, test(), 1000, "uci_housing_test")
