"""How many of a step's device events torch.profiler records, on one CUDA
card: chip_smoke.py's sentiment step (bf16, full width) captured N times
as a bare capture, as chip_smoke.profiled_spans captures it (a pad of spin
kernels first, then the step), and padded inside a capture whose schedule
first warms up on one step, interleaved. Prints, for each, how often the
step's B1/B2 kernels were all counted, the device events kept, and the pad
kernels recorded.

    python3 experiments/torch_profile_capture.py [N]
"""
import collections
import concurrent.futures
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch.ops import cuda_build, lstm_kernels  # noqa: E402

NAMES = ("lstm_fwd_tc_kernel", "lstm_bwd_tc_kernel", "dw_product_kernel")


def spans_of(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def bare(run):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return spans_of(prof), None


def padded(run, warm_first):
    """The pad, then the run (profiled_spans's capture), optionally after
    a warm-up cycle on one run: (the spans after the last pad kernel, pad
    kernels recorded)."""
    kw = dict(schedule=schedule(wait=0, warmup=1, active=1)) if warm_first else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        if warm_first:
            run()
            torch.cuda.synchronize()
            prof.step()
        for _ in range(cs.PROFILE_PAD):
            torch.cuda._sleep(cs.PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    spans = spans_of(prof)
    pads = [i for i, (_, _, n) in enumerate(spans) if "spin_kernel" in n]
    return (spans[pads[-1] + 1:] if pads else spans), len(pads)


def main():
    n_rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    print(torch.__version__, torch.version.cuda, cs.nvidia_smi_line(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_build.build, ("lstm_fwd", "lstm_bwd")))
    sb = cs.SENT_BENCH
    main_p, startup, loss, _ = cs.build_sentiment_program(ptt, **sb)
    main_p.set_amp("bfloat16")
    exe, scope = ptt.Executor(), ptt.Scope()
    exe.run(startup, scope=scope, seed=0)
    feed = cs.sentiment_feed(ptt, np.random.RandomState(70), **sb)
    run = lambda: exe.run(main_p, feed, [loss.name], scope=scope)  # noqa: E731
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    variants = {"bare": bare, "padded": lambda r: padded(r, False),
                "padded_after_warm_up": lambda r: padded(r, True)}
    counted = {k: collections.Counter() for k in variants}
    events = {k: collections.Counter() for k in variants}
    pads = {k: collections.Counter() for k in variants}
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        for k, capture in variants.items():
            spans, n_pad = capture(run)
            counted[k][tuple(sum(1 for *_, n in spans if x in n) for x in NAMES)] += 1
            events[k][len(spans)] += 1
            pads[k][n_pad] += 1
    print(f"{n_rounds} rounds in {time.perf_counter() - t0:.1f} s; counts of {NAMES}")
    for k in variants:
        print(f"{k}: counts {dict(counted[k])}; device events kept {dict(sorted(events[k].items()))}"
              + ("" if k == "bare" else f"; pad kernels recorded of {cs.PROFILE_PAD}: "
                 f"{dict(sorted(pads[k].items()))}"))
    print("chip_smoke.profile_pass:", [cs.profile_pass(run, NAMES)[2] for _ in range(3)])


if __name__ == "__main__":
    main()
