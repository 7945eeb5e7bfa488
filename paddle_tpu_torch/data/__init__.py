"""Data: reader combinators, the DataFeeder and the DevicePrefetcher
(paddle_tpu/data). The JAX package's `recordio` waits for the port's
native surfaces (ROADMAP.md, queue A, A12); `image` and the `datasets`
loaders go with the book models (A1b)."""

from . import reader  # noqa: F401
from .feeder import DataFeeder, DevicePrefetcher  # noqa: F401
from .reader import (batch, buffered, cache, chain, compose, firstn,  # noqa: F401
                     map_readers, shuffle, xmap_readers)
