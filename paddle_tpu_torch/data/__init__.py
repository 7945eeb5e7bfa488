"""Data: reader combinators, the DataFeeder, the DevicePrefetcher and its
FeedWindow, and the book models' first dataset loaders (paddle_tpu/data).
The JAX package's `recordio` waits for the port's native surfaces
(ROADMAP.md, queue A, A12); `image` and the other loaders go with the rest
of the book models (A1b)."""

from . import datasets, reader  # noqa: F401
from .feeder import DataFeeder, DevicePrefetcher, FeedWindow  # noqa: F401
from .reader import (batch, buffered, cache, chain, compose, firstn,  # noqa: F401
                     map_readers, shuffle, xmap_readers)
