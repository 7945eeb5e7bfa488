"""Global flags read by the port (paddle_tpu/flags.py), as a registry of
typed in-process values. Only the flags the ported paths read are
defined; setting or reading any other raises rather than being ignored.
`define_flag` registers one more (the tracing and fault-injection modules
define theirs); an environment variable `PT_FLAGS_<NAME>` overrides a
flag's default, as in the JAX package."""

from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, dict] = {}


def _coerce(value, default):
    """`value` in the type of the flag's default: "1"/"true"/"yes"/"on" for
    a bool given as a string, int(value) for an int flag."""
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return type(default)(value)


class _Flags:
    """Attribute access over the registry: `FLAGS.use_fused_rnn`."""

    def __getattr__(self, name: str):
        try:
            return _REGISTRY[name]["value"]
        except KeyError:
            raise AttributeError(f"undefined flag {name!r}") from None

    def __setattr__(self, name: str, value):
        if name not in _REGISTRY:
            raise AttributeError(f"undefined flag {name!r}")
        _REGISTRY[name]["value"] = _coerce(value, _REGISTRY[name]["default"])


FLAGS = _Flags()


def define_flag(name: str, default, help: str = "") -> None:
    """Register a flag; the environment variable PT_FLAGS_<NAME> overrides
    its default."""
    value: Any = default
    env = os.environ.get(f"PT_FLAGS_{name.upper()}")
    if env is not None:
        value = _coerce(env, default)
    _REGISTRY[name] = {"default": default, "value": value, "help": help}


# -- the kernels' routes ---------------------------------------------------
define_flag("use_fused_rnn", True,
            "dynamic_gru runs the hand-written GRU kernels (ops/rnn_kernels.py) "
            "for sigmoid/tanh gates; off, it takes the plain gru_scan")
define_flag("use_fused_attention", True,
            "attention_gru_decoder runs the hand-written Bahdanau attention "
            "kernels (ops/attention_kernels.py) under its own backward; off, "
            "the plain scan formulation with autograd")
define_flag("use_fused_conv", True,
            "resnet_imagenet's NHWC training bottlenecks build through the "
            "fused raw-stats protocol (fused_conv_bn / bn_stats / bn_apply); "
            "read when the program is built")
define_flag("fused_conv_dot_max_n", 0,
            "fused_conv_bn runs its 1x1 conv as a 2-D product when its rows "
            "N <= this, else as a 1x1 F.conv2d (the 4-D route)")
define_flag("fused_conv_pallas", False,
            "the 2-D product is the hand-written fused conv + BN kernel "
            "(ops/fused_conv_kernels.py) where its eligibility holds; off, "
            "the plain 2-D formula")
define_flag("fused_attention_seq_fwd", False,
            "under use_fused_attention, the decoder's forward is one "
            "whole-sequence kernel (csrc/decoder_seq.cu) instead of a "
            "per-step kernel in a loop; off by default, as in the JAX package")
define_flag("fused_attention_seq_bwd", False,
            "the same for the decoder's backward: one whole-sequence kernel "
            "instead of a per-step kernel in a loop and the phase-2 kernel")
define_flag("stacked_lstm_single_scan", False,
            "run the N-layer stacked_lstm op as one all-layers masked loop "
            "(stacked_lstm_book_scan). Off by default, as in the JAX package: "
            "the book's [4H, 4H] inter-layer concat-fc runs T sequential [B, 4H] "
            "products in the loop, where the default layer-by-layer formulation "
            "runs it as one [T*B, 4H] batched product between the LSTM kernels")
define_flag("bn_bf16_stats", True,
            "batch-norm statistics (batch_norm, bn_stats, fused_conv_bn's "
            "routes other than the kernel) square the activation in its io "
            "dtype and sum in f32; off, they square in f32. On by default, "
            "as in the JAX package")

# -- the training loop (trainer.py) ----------------------------------------
define_flag("step_guard", False,
            "trainer: enable the resilience.StepGuard default policy: skip "
            "non-finite steps, roll back to the last checkpoint after 3 "
            "consecutive, reduced-LR cool-down")
define_flag("log_period", 100, "trainer: log every N batches")
define_flag("sync_every", 0,
            "trainer: host-sync cadence of the step loop: read the on-device "
            "cost/metric accumulator back every N steps. 1 = the synchronous "
            "loop (every step waits for the card); 0 = auto: follow "
            "log_period, except a StepGuard-armed run keeps the per-step "
            "check unless a cadence is set explicitly")
define_flag("scan_window", 0,
            "trainer: run K training steps a host dispatch (Executor.run_window: "
            "on the card one step captured as a CUDA graph and replayed K times); "
            "0 = the per-step loop")
define_flag("prefetch_to_device", 2,
            "trainer: default DevicePrefetcher queue depth: batch N+1's "
            "host-to-device copy overlaps batch N's compute. 0 disables; "
            "Trainer.train(prefetch_to_device=...) overrides per run")
define_flag("show_param_stats_period", 0,
            "trainer: print per-parameter value/gradient stats every N "
            "batches; 0 = off")
define_flag("stats_period", 0,
            "trainer: log a one-line runtime-stats record (step, dispatches, "
            "syncs, checkpoint commits, guard skips, trace drops) every N "
            "steps; 0 = off")
define_flag("enable_timers", False,
            "accumulate REGISTER_TIMER-style stat timers (profiler.timer)")
