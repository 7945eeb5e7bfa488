"""Dataset loaders (paddle_tpu/data/datasets), cut to the book models the
port runs: `uci_housing` (fit_a_line), `mnist` (recognize_digits), `imdb`
(understand_sentiment), `imikolov` (word2vec) and `movielens`
(recommender_system).

Each serves the reference's sample schema and reader API. A loader reads
the real files where they lie under `data_home()` (the environment's
PADDLE_TPU_DATA_HOME, as in the JAX package); otherwise it makes the JAX
loader's seeded synthetic data, the same numbers. Nothing is downloaded:
`common.download` returns a cached, checksum-verified file or raises.
"""

import os


def data_home() -> str:
    return os.environ.get(
        "PADDLE_TPU_DATA_HOME", os.path.expanduser("~/.cache/paddle_tpu/dataset"))
