#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure raises and the script
exits non-zero without the final `ok` line:

  1. device   the card's name, torch/CUDA versions, nvidia-smi's name and
              power limit; TF32 off for matmuls and cuDNN.
  2. build    compiles the CUDA kernels from paddle_tpu_torch/csrc.
  3. kernel   gru_fwd (csrc/gru_fwd.cu) against gru_fwd_plain on the card,
              on x from the full-width artifact's lookup_table + mul for a
              ragged request: forward and reverse, f32 and bf16; errors
              beside their tolerances, both times, the kernel's bound.
              Then a few small shapes whose H does not divide into the
              CTAs' column slices, for the kernel's other tile widths.
  4. slice    the NMT beam-search artifact at bench.py run_infer's widths
              (V=30000, H=512, S=50, beam 4, max_len 32), seeded weights,
              bf16 amp: 3 requests of 128 ragged sentences through
              load_inference_model + Executor.run; shapes, ranges, score
              order, and 2 gru_fwd launches per request; then one more
              request under torch.profiler: device busy share and device
              time by kernel.
  5. parity   the same program at a small width, card (kernel) against
              CPU (plain versions): f32, then bf16 amp.
  6. the kernels JSON line, then the device JSON line last.

Weights are made with numpy from --seed at the shapes the program
declares (normal / sqrt(fan_in)) and written as params.npz beside a copy
of the committed program.json/meta.json: nothing is downloaded and
nothing of the JAX package is needed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel-against-plain tolerances on h. f32: the same f32 arithmetic
# summed in another order (warp shuffles vs a BLAS GEMM) over 50 steps.
# bf16: h and rh are rounded to bf16 at the same places on both sides, but
# a sum that lands near a rounding boundary may round one bf16 ulp apart
# (2^-8 relative, ~4e-3 just below 1). So bf16 is held to one ulp near 1
# and to the share of h_seq's elements that differ. A rounding in the
# wrong place moves h by no more than a sound flip does, but in many more
# elements: phase 3 prints, beside the kernel's share, the share of the
# recurrence rounded to bf16 only at its output, and fails unless the
# bound tells the two apart.
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}
BF16_MAX_DIFFERING = 0.05
# phase 5, card against CPU. f32: scores within 1e-4, ids and lengths
# equal. bf16: encoder state and decoder h0 within one ulp near 1 and a
# share of differing elements (the bounds of tests/test_torch_nmt_infer.py,
# where the port is held to the JAX package). The beams are not held to
# each other: bf16 scores near -200 have a 1.0 ulp, so candidates tie and
# one rounding flip sends a beam elsewhere, where it may find an EOS the
# other does not (the JAX package's beams drift from the port's the same
# way). So a beam that both find must score within two ulps, and at least
# 10% of the beams must be found by both; a decoder computing another
# function shares no 32-token beam with the plain one.
SLICE_SCORE_TOL = 1e-4
BF16_SLICE_MAX_DIFFERING = {"encoder state": 0.02, "decoder h0": 0.10}
BF16_SCORE_ULPS = 2
BF16_MIN_SHARED_BEAMS = 0.10
# (T, B, H) beyond the main path's: on a 132-SM card these take 1, 4 and
# 16 hidden units per CTA, the last two with a partly empty last CTA
EDGE_SHAPES = [(3, 1, 100), (5, 3, 301), (4, 5, 1100)]


def phase(n, name):
    print(f"[phase {n}] {name}", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def write_params(src_dir, dst_dir, seed):
    """Copy an artifact's program.json/meta.json and write seeded weights."""
    os.makedirs(dst_dir, exist_ok=True)
    for f in ("program.json", "meta.json"):
        shutil.copy(os.path.join(src_dir, f), dst_dir)
    with open(os.path.join(src_dir, "program.json")) as f:
        shapes = {v["name"]: v["shape"] for v in json.load(f)["blocks"][0]["vars"]}
    with open(os.path.join(src_dir, "meta.json")) as f:
        names = json.load(f)["param_names"]
    rng = np.random.RandomState(seed)
    arrays = {}
    for n in names:
        shape = shapes[n]
        arrays[n] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    np.savez(os.path.join(dst_dir, "params.npz"), **arrays)


def ragged_feed(ptt, rng, batch, max_len, vocab, min_len):
    lens = rng.randint(min_len, max_len + 1, size=batch)
    lens[0] = max_len
    seqs = [rng.randint(2, vocab, size=(n,)).astype(np.int32) for n in lens]
    return ptt.LoDArray.from_sequences(seqs, capacity=batch * max_len, max_seqs=batch)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def encoder_inputs(ptt, exe, program, scope, feed, amp):
    """x [T,B,3H] (bias added), mask, W and reverse for both encoder GRUs,
    from the artifact's own lookup_table and mul ops on `feed`."""
    d = program.to_dict()
    sub = ptt.Program.from_dict(d)
    sub.global_block().ops = [o for o in sub.global_block().ops
                              if o.type in ("lookup_table", "mul")][:3]
    sub.set_amp(amp)
    grus = [o for o in program.global_block().ops if o.type == "dynamic_gru"]
    projs = [g.inputs["Input"][0] for g in grus]
    outs = exe.run(sub, {"src": feed}, projs, scope=scope, return_numpy=False)
    cases = []
    for g, lod in zip(grus, outs):
        x, mask = lod.to_batch(max_len=g.attrs["max_len"])
        w = scope.get(g.inputs["Weight"][0])
        b = scope.get(g.inputs["Bias"][0])
        cases.append((x + b.to(x.dtype), mask, w.to(x.dtype), bool(g.attrs["is_reverse"])))
    return cases


def bound(x, mask, w, h_seq, h_T):
    """Least time the card could take for this GRU, counted over the valid
    tokens (a padded step only carries h and needs no x): the bytes of x's
    valid rows, the mask and W read once and h_seq and h_T written once,
    over HBM bandwidth; the products the valid tokens need (2*3H*H each),
    over the dtype's dense peak."""
    tokens = float(mask.float().sum())
    nbytes = tokens * x.shape[2] * x.element_size() + sum(
        t.numel() * t.element_size() for t in (mask, w, h_seq, h_T))
    H = w.shape[0]
    flops = 2.0 * tokens * 3 * H * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[x.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, flops


def bf16_ulp(v):
    """One bf16 ulp at each element's magnitude (numpy float array)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def kernel_error(got, want, dt):
    """(max abs error over h_seq and h_T, share of h_seq elements that
    differ); fails past the dtype's bounds."""
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    differing = float((got[0] != want[0]).float().mean())
    check(all(torch.isfinite(t.float()).all() for t in got), "non-finite kernel output")
    check(err <= TOL[dt], f"gru_fwd disagrees with its plain version: {err}")
    check(dt != torch.bfloat16 or differing <= BF16_MAX_DIFFERING,
          f"gru_fwd differs from its plain version in {differing:.4%} of h_seq")
    return err, differing


def breakdown(run, median_ms):
    """One call of `run` under torch.profiler: device busy time, as a
    share of the profiled wall time (which the profiler's own host cost
    inflates) and of the unprofiled median, and device time by kernel
    name, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("  profiler: no device events recorded; breakdown not measured")
        return
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    print(f"  profiled request: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% of the profiled wall, "
          f"{100 * busy / 1e3 / median_ms:.1f}% of the unprofiled median), "
          f"{len(spans)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / 1e3:9.3f} ms  {name[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    phase(1, "device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import cuda_build, rnn_kernels

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print("nvidia-smi name, power.limit:")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    phase(2, "build")
    t0 = time.perf_counter()
    path = cuda_build.build("gru_fwd")
    print(f"built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(cuda_build.BUILD_DIR, "gru_fwd.log")) as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
    rnn_kernels._lib()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        wmt_dir = os.path.join(work, "nmt_beam_wmt")
        t0 = time.perf_counter()
        write_params(os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_beam_wmt"),
                     wmt_dir, args.seed)
        scope = ptt.Scope()
        program, feeds, fetches = ptt.io.load_inference_model(wmt_dir, scope=scope)
        print(f"artifact: seeded params written and loaded in {time.perf_counter() - t0:.2f} s")
        attrs = program.global_block().ops[-1].attrs
        V = scope.get("s2s.trg_emb").shape[0]
        S, K, T, B = attrs["src_max_len"], attrs["beam_size"], attrs["max_len"], 128
        rng = np.random.RandomState(args.seed)

        phase(3, "kernel against plain")
        feed = ragged_feed(ptt, rng, B, S, V, min_len=10)
        exe = ptt.Executor()
        print("cuBLAS bf16 reduced-precision reduction: "
              f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
        max_err, main_row = 0.0, None
        for amp, dt in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
            for x, mask, w, reverse in encoder_inputs(ptt, exe, program, scope, feed, amp):
                check(x.dtype == dt, f"encoder x dtype {x.dtype}, expected {dt}")
                got = rnn_kernels.gru_fwd(x, mask, w, reverse=reverse)
                want = rnn_kernels.gru_fwd_plain(x, mask, w, reverse=reverse)
                torch.cuda.synchronize()
                k_ms = cuda_ms(lambda: rnn_kernels.gru_fwd(x, mask, w, reverse=reverse), 20)
                p_ms = cuda_ms(lambda: rnn_kernels.gru_fwd_plain(x, mask, w, reverse=reverse), 5)
                b_ms, b_by, nbytes, flops = bound(x, mask, w, *got)
                T_, B_, H3 = x.shape
                print(f"  gru_fwd T={T_} B={B_} H={H3 // 3} {str(dt)[6:]} "
                      f"{'rev' if reverse else 'fwd'}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"bound {b_ms:.5f} ms by {b_by} ({nbytes:.0f} B, {flops:.4g} FLOP)")
                err, differing = kernel_error(got, want, dt)
                print(f"    max_abs_err={err:.3e} (tol {TOL[dt]:g}), h_seq differing "
                      f"{differing:.4%}" + (f" (max {BF16_MAX_DIFFERING:.0%})"
                                            if dt == torch.bfloat16 else ""))
                if dt == torch.bfloat16:
                    f32_seq = rnn_kernels.gru_fwd_plain(x.float(), mask, w.float(),
                                                        reverse=reverse)[0].to(dt)
                    off = float((f32_seq != got[0]).float().mean())
                    off_err = float((f32_seq.float() - got[0].float()).abs().max())
                    print(f"    rounded only at the output: {off_err:.3e} apart, "
                          f"h_seq differing {off:.4%}")
                    check(off > BF16_MAX_DIFFERING,
                          "the bf16 share bound does not catch a misplaced rounding")
                max_err = max(max_err, err)
                if dt == torch.bfloat16 and not reverse:  # the main path's dtype
                    main_row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        for (T_, B_, H_), dt, reverse in [(s, dt, rev) for s in EDGE_SHAPES
                                          for dt in TOL for rev in (False, True)]:
            lens = torch.as_tensor(rng.randint(1, T_ + 1, size=B_))
            mask = (torch.arange(T_)[:, None] < lens[None, :]).cuda()
            x = torch.as_tensor(rng.standard_normal((T_, B_, 3 * H_)), dtype=dt).cuda()
            w = torch.as_tensor(rng.standard_normal((H_, 3 * H_)) / np.sqrt(H_), dtype=dt).cuda()
            got = rnn_kernels.gru_fwd(x, mask, w, reverse=reverse)
            want = rnn_kernels.gru_fwd_plain(x, mask, w, reverse=reverse)
            torch.cuda.synchronize()
            err, differing = kernel_error(got, want, dt)
            print(f"  gru_fwd T={T_} B={B_} H={H_} {str(dt)[6:]} {'rev' if reverse else 'fwd'}: "
                  f"max_abs_err={err:.3e} (tol {TOL[dt]:g}), h_seq differing {differing:.4%}")
            max_err = max(max_err, err)

        phase(4, "slice at full width (bf16)")
        program.set_amp("bfloat16")
        requests = [ragged_feed(ptt, rng, B, S, V, min_len=10) for _ in range(3)]
        exe.run(program, {feeds[0]: requests[0]}, fetches, scope=scope)  # warm-up
        rnn_kernels.gru_fwd_launches = 0
        times, outs = [], []
        for req in requests:
            t0 = time.perf_counter()
            outs.append(exe.run(program, {feeds[0]: req}, fetches, scope=scope))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = rnn_kernels.gru_fwd_launches
        for ids, sc, lens in outs:
            check(ids.shape == (B, K, T) and sc.shape == (B, K) and lens.shape == (B, K),
                  f"shapes {ids.shape} {sc.shape} {lens.shape}")
            check(((ids >= 0) & (ids < V)).all(), "ids out of [0, V)")
            check(((lens >= 1) & (lens <= T)).all(), "lengths out of [1, max_len]")
            check(np.isfinite(sc).all(), "non-finite scores")
            check((np.diff(sc, axis=1) <= 0).all(), "scores not sorted best first")
        check(launches == 2 * len(requests),
              f"gru_fwd launched {launches} times for {len(requests)} requests")
        med = statistics.median(times)
        print(f"  requests ms: {[round(t, 3) for t in times]}; gru_fwd launches {launches}")
        print(f"  median {med:.3f} ms/request, {B * T / med * 1e3:.1f} generated tokens/s "
              f"(B={B}, beam {K}, max_len {T}) on {smi}")
        breakdown(lambda: exe.run(program, {feeds[0]: requests[0]}, fetches, scope=scope), med)

        phase(5, "small-width slice: card against CPU (f32, then bf16)")
        small = os.path.join(work, "nmt_beam_small")
        write_params(os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_beam_small"),
                     small, args.seed + 1)
        for amp in (None, "bfloat16"):
            res = {}
            for dev in ("cpu", "cuda"):
                sc_ = ptt.Scope()
                prog, fd, ft = ptt.io.load_inference_model(small, scope=sc_, device=dev)
                prog.set_amp(amp)
                beam = prog.global_block().ops[-1]
                a = beam.attrs
                vs = sc_.get("s2s.trg_emb").shape[0]
                feed = ragged_feed(ptt, np.random.RandomState(args.seed + 2), 16,
                                   a["src_max_len"], vs, min_len=1)
                names = [beam.inputs["EncState"][0], beam.inputs["H0"][0]] + list(ft)
                enc, h0, *fetched = ptt.Executor(device=dev).run(prog, {fd[0]: feed}, names,
                                                                 scope=sc_)
                res[dev] = [enc.data.float().cpu().numpy(), h0] + fetched
            (ce, ch, ci, cs, cl), (ge, gh, gi, gs, gl) = res["cpu"], res["cuda"]
            score_err = float(np.abs(cs - gs).max())
            if amp is None:
                print(f"  f32: ids equal: {np.array_equal(ci, gi)}; lengths equal: "
                      f"{np.array_equal(cl, gl)}; max score diff {score_err:.3e} "
                      f"(tol {SLICE_SCORE_TOL:g})")
                check(np.array_equal(ci, gi) and np.array_equal(cl, gl),
                      "card and CPU ids/lengths differ")
                check(score_err <= SLICE_SCORE_TOL, "card and CPU scores differ")
                continue
            for name, g, c in (("encoder state", ge, ce), ("decoder h0", gh, ch)):
                err, differing = float(np.abs(g - c).max()), float(np.mean(g != c))
                print(f"  bf16 {name}: max abs diff {err:.3e} (tol {TOL[torch.bfloat16]:g}), "
                      f"differing {differing:.4%} (max {BF16_SLICE_MAX_DIFFERING[name]:.0%})")
                check(err <= TOL[torch.bfloat16] and differing <= BF16_SLICE_MAX_DIFFERING[name],
                      f"card and CPU {name} differ under bf16")
            shared = np.all(ci == gi, axis=-1)  # [B, K] beams both found
            score_ulps = float((np.abs(cs - gs) / bf16_ulp(cs))[shared].max(initial=0.0))
            print(f"  bf16 beams: {shared.mean():.1%} found by both (min "
                  f"{BF16_MIN_SHARED_BEAMS:.0%}); their scores at most {score_ulps:g} bf16 "
                  f"ulps apart (max {BF16_SCORE_ULPS}); all scores at most {score_err:g} apart")
            check(shared.mean() >= BF16_MIN_SHARED_BEAMS, "card and CPU beams differ under bf16")
            check(score_ulps <= BF16_SCORE_ULPS, "card and CPU scores differ under bf16")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "gru_fwd", "route": "cuda", "source": "paddle_tpu_torch/csrc/gru_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:493", "launches": launches,
        "max_abs_err": max_err, **main_row, "library_ms": None,
        "checked_against_plain": True,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
