"""Readings for setting a cell's `correct` limits: the numbers a run
compares, over many seeds in one process, for the program (sound
runs), the lower-precision control in its place, or a planted fault.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--mode program|control|fault:<name>] [--seconds S] \
        [--override '<json>'] [--out FILE]

Each seed prints one JSON line {seed, mode, readings, correct}; the
last line holds each number's largest and smallest reading.  Needs the
cards the cell asks for, as a run does.  Not part of a benchmark run.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--override", default="{}")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    fault = args.mode.split(":", 1)[1] if args.mode.startswith(
        "fault:") else None
    lines = []
    for seed in args.seeds:
        t = time.perf_counter()
        harness.T0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        try:
            readings = {}
            res = harness.execute(
                ROOT, args.workload, seed, args.seconds, False,
                overrides=json.loads(args.override), fault=fault,
                control=args.mode == "control", readings=readings)
            line = dict(seed=seed, mode=args.mode, correct=res["correct"],
                        readings=readings, metrics=res["metrics"],
                        seconds=time.perf_counter() - t)
        except Exception as e:  # a control that crashes has failed
            line = dict(seed=seed, mode=args.mode, error=repr(e))
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(dict(line, workload=args.workload))
                        + "\n")
    keys = sorted({k for ln in lines for k in ln.get("readings", {})})
    summary = {k: [min(ln["readings"][k] for ln in lines
                       if "readings" in ln),
                   max(ln["readings"][k] for ln in lines
                       if "readings" in ln)] for k in keys}
    print(json.dumps(dict(workload=args.workload, mode=args.mode,
                          min_max=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
