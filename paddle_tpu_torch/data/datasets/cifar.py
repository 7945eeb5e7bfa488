"""CIFAR-10/100 (paddle_tpu/data/datasets/cifar.py; the reference's
python/paddle/v2/dataset/cifar.py): samples of (image [3072] float32 in
[0, 1], label int), 3x32x32 flattened.

The python-pickle archives are read where they lie under
data_home()/cifar: pickle is the reference's format, so only a trusted
archive belongs there.
Otherwise the JAX loader's seeded synthetic data: class-conditional smooth
colour fields (8x8 templates upsampled 4x) plus noise, squashed into
(0, 1), 4000 train and 800 test images.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from . import data_home

_N_TRAIN, _N_TEST = 4000, 800


def _real_archive(name):
    p = os.path.join(data_home(), "cifar", name)
    return p if os.path.exists(p) else None


def _read_real(archive, is_train):
    with tarfile.open(archive) as tf:
        for member in tf.getmembers():
            base = os.path.basename(member.name)
            is_batch = (
                base.startswith("data_batch") if is_train else base == "test_batch"
            ) or (base == "train" if is_train else base == "test")
            if not is_batch:
                continue
            d = pickle.load(tf.extractfile(member), encoding="latin1")
            labels = d.get("labels", d.get("fine_labels"))
            for img, lbl in zip(d["data"], labels):
                yield img.astype(np.float32) / 255.0, int(lbl)


def _synthetic(n, n_classes, seed):
    rng = np.random.RandomState(1234 + n_classes)
    low = rng.randn(n_classes, 3, 8, 8).astype(np.float32)
    templates = low.repeat(4, axis=2).repeat(4, axis=3).reshape(n_classes, 3072)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n)
    imgs = templates[labels] * 0.5 + 0.35 * rng.randn(n, 3072).astype(np.float32)
    imgs = 1.0 / (1.0 + np.exp(-imgs))  # squash to (0,1) like real pixels
    return imgs.astype(np.float32), labels.astype(np.int64)


def _reader(n_classes, is_train):
    archive = _real_archive(
        "cifar-10-python.tar.gz" if n_classes == 10 else "cifar-100-python.tar.gz"
    )

    def reader():
        if archive:
            yield from _read_real(archive, is_train)
        else:
            n = _N_TRAIN if is_train else _N_TEST
            imgs, labels = _synthetic(n, n_classes, 7 if is_train else 8)
            for i in range(n):
                yield imgs[i], int(labels[i])

    return reader


def train10():
    return _reader(10, True)


def test10():
    return _reader(10, False)


def train100():
    return _reader(100, True)


def test100():
    return _reader(100, False)


def convert(path):
    """Recordio shards of the four splits (the reference's cifar.py:132);
    `common.convert` raises until recordio is ported."""
    from . import common
    common.convert(path, train100(), 1000, "cifar_train100")
    common.convert(path, test100(), 1000, "cifar_test100")
    common.convert(path, train10(), 1000, "cifar_train10")
    common.convert(path, test10(), 1000, "cifar_test10")
