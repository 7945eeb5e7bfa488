"""Op kernels: importing this package registers every ported op."""

from . import (  # noqa: F401
    activation_ops,
    attention_ops,
    control_flow_ops,
    cost_ops,
    crf_ops,
    ctc_ops,
    detection_ops,
    flash_ops,
    fused_conv_ops,
    generation_ops,
    math_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    quant_kernels,
    recurrent_ops,
    rnn_ops,
    sequence_ops,
)
