"""MNIST (paddle_tpu/data/datasets/mnist.py): samples of (image[784]
float32 in [-1, 1], label int).

The IDX files (gzip) are read where they lie under data_home()/mnist;
otherwise the JAX loader's seeded synthetic digits: each class a fixed
smooth 28x28 template (a 7x7 random field upsampled 4x) plus noise.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import data_home

_N_TRAIN, _N_TEST = 8000, 1000


def _load_idx(img_path, lbl_path):
    with gzip.open(lbl_path, "rb") as f:
        magic, n_lbl = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"corrupt MNIST label file {lbl_path}: magic={magic}")
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    with gzip.open(img_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"corrupt MNIST image file {img_path}: magic={magic}")
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    if n != n_lbl or len(labels) != n:
        raise ValueError(f"MNIST image/label count mismatch: {n} vs {n_lbl}")
    images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    return images, labels.astype(np.int64)


def _synthetic(n, seed):
    rng = np.random.RandomState(42)
    low = rng.randn(10, 7, 7).astype(np.float32)
    templates = low.repeat(4, axis=1).repeat(4, axis=2).reshape(10, 784)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = templates[labels] * 0.6 + 0.5 * rng.randn(n, 784).astype(np.float32)
    return np.clip(images, -1.0, 1.0).astype(np.float32), labels


def _data(split):
    home = os.path.join(data_home(), "mnist")
    files = {"train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
             "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}[split]
    paths = [os.path.join(home, f) for f in files]
    if all(os.path.exists(p) for p in paths):
        return _load_idx(*paths)
    n, seed = (_N_TRAIN, 0) if split == "train" else (_N_TEST, 1)
    return _synthetic(n, seed)


def _reader(split):
    def reader():
        images, labels = _data(split)
        for i in range(images.shape[0]):
            yield images[i], int(labels[i])

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def convert(path):
    """Recordio shards of both splits (common.convert: not ported yet)."""
    from . import common

    common.convert(path, train(), 1000, "mnist_train")
    common.convert(path, test(), 1000, "mnist_test")
