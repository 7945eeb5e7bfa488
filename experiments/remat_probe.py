"""Where a remat step's memory goes, and what a CUDA generator allows while
a step is being captured, on one CUDA card.

1. chip_smoke.py's transformer row (bench.py's: dim 2048, 8 layers, B=8,
   T=1024, bf16, Adam) under no remat and each memory_optimize policy:
   the allocated GiB at the step's start, the forward's peak and what it
   leaves, the backward's peak and what it leaves, and the optimizer ops'
   peak (the step's second run, from the startup's state).
2. A generator registered with a graph, while the graph captures: whether
   get_state, clone_state, set_state (another seed's state) and a
   graph-safe swap to another registered generator's state each run, or
   the error each raises. Run in a child process, so a broken capture
   cannot reach part 1.

    python3 experiments/remat_probe.py
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch.core import executor as ex  # noqa: E402
from paddle_tpu_torch.ops import cuda_build, flash_kernels  # noqa: E402

GEN_CHECK = r'''
import torch
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
for what in ("get_state", "clone_state", "set_state", "graphsafe_swap"):
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    other = torch.Generator(device="cuda")
    other.manual_seed(1)
    if what == "graphsafe_swap":
        g.register_generator_state(other)
    s = torch.cuda.Stream()
    res = "ran"
    with torch.cuda.stream(s):
        g.capture_begin(capture_error_mode="thread_local")
        try:
            if what == "get_state":
                gen.get_state()
            elif what == "clone_state":
                gen.clone_state()
            elif what == "set_state":
                gen.set_state(other.get_state())
            else:
                cur = gen.graphsafe_get_state()
                gen.graphsafe_set_state(other.graphsafe_get_state())
                torch.rand(4, device="cuda", generator=gen)
                gen.graphsafe_set_state(cur)
        except Exception as e:
            res = type(e).__name__ + ": " + str(e).splitlines()[0][:200]
        try:
            g.capture_end()
        except Exception as e:
            res += " | capture_end: " + str(e).splitlines()[0][:120]
    torch.cuda.synchronize()
    print("generator during capture:", what, "->", res, flush=True)
'''


def main():
    if not torch.cuda.is_available():
        sys.exit("this probe needs a CUDA card")
    print(cs.nvidia_smi_line())
    cuda_build.build("flash_attn")
    flash_kernels._lib()
    rec = {}
    orig = ex.Executor._run_autodiff

    def split(op, env, leaves, tape=None):
        torch.cuda.synchronize()
        rec.update(fwd_peak=torch.cuda.max_memory_allocated(),
                   after_fwd=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        orig(op, env, leaves, tape)
        torch.cuda.synchronize()
        rec.update(bwd_peak=torch.cuda.max_memory_allocated(),
                   after_bwd=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    ex.Executor._run_autodiff = staticmethod(split)
    main_p, startup, loss = cs.build_transformer_program(ptt, **cs.TFM_BENCH)
    main_p.set_amp("bfloat16")
    b = cs.TFM_BENCH
    feed = cs.transformer_feed(np.random.RandomState(0), b["vocab"], b["seqlen"], b["batch"])
    exe = ptt.Executor()
    for policy in (None, "full", "dots", "dots_no_batch"):
        main_p.remat_policy = policy
        sc = ptt.Scope()
        exe.run(startup, scope=sc, seed=0)
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec["start"] = torch.cuda.memory_allocated()
            exe.run(main_p, feed, [loss.name], scope=sc)
            torch.cuda.synchronize()
            rec["optimizer_peak"] = torch.cuda.max_memory_allocated()
        print(f"{policy or 'no remat'}: GiB " + ", ".join(
            f"{k} {v / 2**30:.3f}" for k, v in rec.items()), flush=True)
        del sc
        torch.cuda.empty_cache()
    ex.Executor._run_autodiff = staticmethod(orig)
    r = subprocess.run([sys.executable, "-c", GEN_CHECK], capture_output=True, text=True,
                       timeout=300)
    print(r.stdout, end="")
    if r.returncode:
        print(r.stderr[-2000:])
        sys.exit(r.returncode)


if __name__ == "__main__":
    main()
