"""Model zoo (paddle_tpu/models), cut to the ported models."""

from .image import (alexnet, googlenet, lenet, resnet_cifar10, resnet_imagenet,  # noqa: F401
                    smallnet, vgg)
from .seq2seq import seq2seq_attention, seq2seq_beam_decode  # noqa: F401
from .text import lstm_benchmark_net, stacked_lstm_net, word2vec_net  # noqa: F401
from .transformer import transformer_lm  # noqa: F401

__all__ = ["alexnet", "googlenet", "lenet", "lstm_benchmark_net", "resnet_cifar10",
           "resnet_imagenet", "seq2seq_attention", "seq2seq_beam_decode", "smallnet",
           "stacked_lstm_net", "transformer_lm", "vgg", "word2vec_net"]
