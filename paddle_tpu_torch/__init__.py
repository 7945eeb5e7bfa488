"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one. It imports torch and numpy, never
jax and never paddle_tpu: programs, parameters and artifacts pass between
the two through the `Program.to_dict` schema and the
`program.json`/`params.npz`/`meta.json` artifact format. Entry points run
on the card (`device="cuda"`) unless the caller passes `device="cpu"`.

It serves inference from a saved artifact:

    program, feeds, fetches = paddle_tpu_torch.io.load_inference_model(d)
    out = paddle_tpu_torch.Executor().run(program, {feeds[0]: lod}, fetches)

trains a program the JAX package saved (`io.load_train_program`), and
trains programs built with its own layer DSL and optimizer front end:

    with ptt.program_guard(main, startup):
        words = ptt.layers.data("words", [-1], np.int32, lod_level=1,
                                append_batch_size=False)
        ...
        ptt.optimizer.Adam(2e-3).minimize(loss)
    exe = ptt.Executor()
    exe.run(startup, scope=scope)
    exe.run(main, feed, [loss], scope=scope)

quantizes a saved artifact to int8 for serving (`quant.calibrate`,
`quant.convert`, `io.save_inference_model`), and trains over a reader
with events, on-device metric accumulation, prefetch to the card and
checkpoints it resumes from:

    trainer = ptt.Trainer(loss, main_program=main, startup_program=startup,
                          checkpoint_config=ptt.CheckpointConfig(d, step_interval=100))
    trainer.train(ptt.data.batch(reader, 64), num_passes=2, feed_order=[x, y],
                  event_handler=handler)

trains across processes and by stages (`parallel.ParallelExecutor` over
torch.distributed, `PipelineExecutor`), and serves saved artifacts over HTTP, with continuous batching for
generation models (`layers.BeamSearchDecoder`):

    reg = ptt.serving.ModelRegistry()
    reg.add("default", model_dir=d, scheduler_kw={"max_slots": 8})
    server = ptt.serving.make_server(reg)
    server.serve_background()          # POST /predict, /generate
"""

from . import (data, evaluator, fleetctl, initializer, io, layers, models,  # noqa: F401
               networks, obs, ops, optimizer, parallel, pipeline, profiler, quant,
               regularizer, resilience, serving)
from .core.backward import append_backward
from .core.executor import Executor, Scope, global_scope, memory_optimize, reset_global_scope
from .core.lod import LoDArray
from .core.program import (Program, default_main_program, default_startup_program,
                           program_guard, reset_default_programs)
from .flags import FLAGS
from .gradient_checker import check_gradient
from .param_attr import ParamAttr
from .pipeline import PipelineExecutor
from .trainer import (BeginIteration, BeginPass, CheckpointConfig, EndIteration, EndPass,
                      Trainer)

__all__ = ["BeginIteration", "BeginPass", "CheckpointConfig", "EndIteration", "EndPass",
           "Executor", "FLAGS", "LoDArray", "ParamAttr", "Program", "Scope", "Trainer",
           "append_backward", "check_gradient", "data", "default_main_program",
           "default_startup_program", "evaluator", "fleetctl", "global_scope", "initializer", "io", "layers", "memory_optimize", "models", "networks", "obs", "ops",
           "optimizer", "parallel", "pipeline", "PipelineExecutor", "profiler", "program_guard", "quant", "regularizer",
           "reset_default_programs", "reset_global_scope", "resilience", "serving"]
