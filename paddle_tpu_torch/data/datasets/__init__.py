"""Dataset loaders (paddle_tpu/data/datasets) of the book's models:
`uci_housing` (fit_a_line), `mnist` (recognize_digits), `cifar`
(image_classification), `imdb` and `sentiment` (understand_sentiment),
`imikolov` (word2vec), `movielens` (recommender_system), `conll05`
(label_semantic_roles), `wmt14` and `wmt16` (machine_translation).

Each serves the reference's sample schema and reader API. A loader reads
the real files where they lie under `data_home()` (the environment's
PADDLE_TPU_DATA_HOME, as in the JAX package); otherwise it makes the JAX
loader's seeded synthetic data, the same numbers (`conll05` and
`sentiment` have only that). Nothing is downloaded:
`common.download` returns a cached, checksum-verified file or raises.
"""

import os


def data_home() -> str:
    return os.environ.get(
        "PADDLE_TPU_DATA_HOME", os.path.expanduser("~/.cache/paddle_tpu/dataset"))


# the loaders, after data_home(), which they import
from . import (cifar, common, conll05, imdb, imikolov, mnist, movielens,  # noqa: E402,F401
               sentiment, uci_housing, wmt14, wmt16)

__all__ = ["cifar", "common", "conll05", "data_home", "imdb", "imikolov", "mnist", "movielens",
           "sentiment", "uci_housing", "wmt14", "wmt16"]
