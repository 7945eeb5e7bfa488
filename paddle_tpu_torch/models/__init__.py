"""Model zoo (paddle_tpu/models), cut to the ported models."""

from .image import resnet_imagenet  # noqa: F401
from .seq2seq import seq2seq_attention, seq2seq_beam_decode  # noqa: F401
from .text import lstm_benchmark_net, stacked_lstm_net, word2vec_net  # noqa: F401
from .transformer import transformer_lm  # noqa: F401

__all__ = ["lstm_benchmark_net", "resnet_imagenet", "seq2seq_attention", "seq2seq_beam_decode",
           "stacked_lstm_net", "transformer_lm", "word2vec_net"]
