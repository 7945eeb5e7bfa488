"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one. It imports torch and numpy, never
jax and never paddle_tpu: programs, parameters and artifacts pass between
the two through the `Program.to_dict` schema and the
`program.json`/`params.npz`/`meta.json` artifact format. Entry points run
on the card (`device="cuda"`) unless the caller passes `device="cpu"`.

This slice serves inference from a saved artifact:

    program, feeds, fetches = paddle_tpu_torch.io.load_inference_model(d)
    out = paddle_tpu_torch.Executor().run(program, {feeds[0]: lod}, fetches)
"""

from . import io, ops  # noqa: F401  (ops: registers the kernels)
from .core.executor import Executor, Scope, global_scope
from .core.lod import LoDArray
from .core.program import Program
from .flags import FLAGS

__all__ = ["Executor", "FLAGS", "LoDArray", "Program", "Scope", "global_scope",
           "io", "ops"]
