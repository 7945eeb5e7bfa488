"""Data: reader combinators, the DataFeeder, the DevicePrefetcher and its
FeedWindow, image augmentation (`image`) and the book models' dataset
loaders (paddle_tpu/data). The JAX package's `recordio` waits for the
port's native surfaces (ROADMAP.md, queue A, A12)."""

from . import datasets, image, reader  # noqa: F401
from .feeder import DataFeeder, DevicePrefetcher, FeedWindow  # noqa: F401
from .reader import (batch, buffered, cache, chain, compose, firstn,  # noqa: F401
                     map_readers, shuffle, xmap_readers)
