"""chip_smoke.py's phase 52 (bench.py's serving_gen_v3 on one CUDA card: v2
mode, then the fp and int8 prefix caches with the draft) run REPS times in
one process, with all of the phase's checks. Prints one JSON line: each
pass's open-loop effective tokens/s, closed-loop first-token p50 (s) and
host syncs, a list with one entry a repetition.

To compare two checkouts within one call, run it from the root of each in
turn (parent, change, change, parent):

    python3 experiments/serving_round_ab.py [--reps 3] [--tag NAME]
"""
import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402

PASSES = ("v2_mode", "fp_cached", "int8_cached")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tag", default=os.path.basename(ROOT))
    args = ap.parse_args()
    cs.check(cs.torch.cuda.is_available(), "needs a CUDA card")
    smi = cs.nvidia_smi_line()
    out = {"tag": args.tag, "device": smi,
           **{p: {"tok_per_s": [], "first_token_p50_s": [], "host_syncs": []} for p in PASSES}}
    with tempfile.TemporaryDirectory() as work:
        v3 = cs.serving_gen_v3_setup(ptt, 0, work)
        for _ in range(args.reps):
            with contextlib.redirect_stdout(io.StringIO()):
                res = cs.serving_gen_v3_phase(ptt, smi, 52, v3)
            for p in PASSES:
                out[p]["tok_per_s"].append(res[p]["effective_tok_per_s"])
                out[p]["first_token_p50_s"].append(res[p]["first_token_s_p50"])
                out[p]["host_syncs"].append(res[p]["host_syncs"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
