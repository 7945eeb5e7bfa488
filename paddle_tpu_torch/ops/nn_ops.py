"""Normalisation and loss op kernels: `layer_norm` and
`softmax_with_cross_entropy` (paddle_tpu/ops/nn_ops.py:191-207, 247-272),
on torch tensors."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy_kernel(ctx):
    """Log-softmax in f32 even under amp (loss numerics). Ragged (LoDArray)
    logits give a per-token LoD loss [capacity, 1] with the padding slots
    zeroed. Softmax is set only where the run reads it: the training
    program does not, and at [B·T, V] it is the step's largest tensor."""
    logits_in = ctx.input("Logits")
    label_in = ctx.input("Label")
    ragged = isinstance(logits_in, LoDArray)
    logits = logits_in.data if ragged else logits_in
    label = label_in.data if isinstance(label_in, LoDArray) else label_in
    if ctx.attr("soft_label", False):
        raise NotImplementedError("softmax_with_cross_entropy: soft labels are not "
                                  "ported yet")
    logp = torch.log_softmax(logits.float(), dim=-1)
    lbl = label[..., 0] if label.dim() == logits.dim() else label
    lbl = lbl.long().clamp(0, logits.shape[-1] - 1)
    loss = -torch.gather(logp, -1, lbl[..., None])
    wrap = logits_in.with_data if ragged else (lambda t: t)
    if ragged:
        loss = torch.where(logits_in.token_mask[:, None], loss, torch.zeros((), device=loss.device))
    if ctx.output_read("Softmax"):
        ctx.set_output("Softmax", wrap(logp.exp()))
    ctx.set_output("Loss", wrap(loss))


@register_op("layer_norm")
def layer_norm_kernel(ctx):
    """Normalises over the axes from begin_norm_axis on: statistics in f32
    (the biased variance) even under amp, the f32 Scale and Bias applied in
    f32, the output in x's dtype."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(ctx.attr("begin_norm_axis", 1), x.dim()))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    if ctx.has_input("Scale"):
        out = out * ctx.input("Scale")
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias")
    ctx.set_output("Y", out.to(x.dtype))
