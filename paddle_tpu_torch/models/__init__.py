"""Model zoo (paddle_tpu/models), cut to the ported models."""

from .image import resnet_imagenet  # noqa: F401
from .text import lstm_benchmark_net  # noqa: F401
from .transformer import transformer_lm  # noqa: F401

__all__ = ["lstm_benchmark_net", "resnet_imagenet", "transformer_lm"]
