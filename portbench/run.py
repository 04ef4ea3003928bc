"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the CUDA cards the
cell asks for.  The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, with --trace 1 a
breakdown, and last the numbers compared for `correct` with their
limits, which also end standard error.  Exits nonzero, printing no
result, without the cards, or if a JAX module is loaded at the end.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the interpreter's compiled modules at a fixed place inside the checkout
# (a fresh machine compiles torch's sources on every start otherwise; the
# port's kernels build into build/kernels/ there by themselves); a
# library the port uses must not load JAX
sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")
sys.dont_write_bytecode = False
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.lib import harness
    cell = harness.Cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    harness.T0 = T0
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    res = harness.execute(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in res["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
