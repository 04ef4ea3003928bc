"""The program's span table of one traced run of a cell.

    python3 portbench/span_table.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

Runs the cell as `run.py --trace 1` does (its result line and standard
error as there) and keeps the traced slice's trace, which the runners
reduce to their own numbers only.  Then it prints one JSON line more
(and writes it to --out): per step or per view of the slice, each
`ngp.*` span's calls and its forward, backward, idle and total device
ms (`lib/program_spans.py`), the root's own ms, what no span holds, the
busy and wall ms, the layer spans' coverage, and the change of the
program's counters.  In a training cell it adds the encoder's device ms
by its span beside the benchmark's own encoder ranges (`lib/spans.py`),
which time the same kernels from outside the program.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def table(t, counts, per: int, unit: str, cell):
    from portbench.lib import program_spans, spans
    red = program_spans.reduce(t)
    ms = 1e3 / per
    out = dict(
        workload=cell, unit=unit, per=per, window_ms=t.window_s * ms,
        busy_ms=t.busy_s * ms, layer_ms=red["layer_s"] * ms,
        outside_ms=red["outside_s"] * ms,
        outside_idle_ms=red["outside_idle_s"] * ms,
        coverage=red["coverage"], counters=counts,
        spans={n: dict(calls=s["calls"] / per, fwd_ms=s["fwd_s"] * ms,
                       bwd_ms=s["bwd_s"] * ms, idle_ms=s["idle_s"] * ms,
                       total_ms=s["total_s"] * ms)
               for n, s in red["spans"].items()})
    if unit == "step":
        fwd = t.launched_in(t.ranges(spans.ENC_FWD, exclude=spans.GRID))
        bwd = t.launched_in(t.ranges(spans.ENC_BWD))
        enc = red["spans"].get("ngp.encoder", {})
        out["encoder_check"] = dict(
            span_fwd_ms=enc.get("fwd_s", 0.0) * ms,
            range_fwd_ms=t.device_seconds(fwd) * ms,
            span_bwd_ms=enc.get("bwd_s", 0.0) * ms,
            range_bwd_ms=t.device_seconds(bwd) * ms)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import run  # puts the checkout on the path, as run.py's own start
    from google_nerf_tpu_torch.utils import logging as plog
    from portbench.lib import common, harness
    kept = []
    traced = common.traced

    def keep(fn, dev):
        kept.append(traced(fn, dev))
        return kept[-1]

    common.traced = keep
    before = plog.counters()
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not kept:
        return rc or 1
    after = plog.counters()
    counts = {k: v - before.get(k, 0) for k, v in after.items()}
    traffic = harness.Cell(ROOT, args.workload).traffic
    unit = "step" if "trace_steps" in traffic else "view"
    per = traffic["trace_steps" if unit == "step" else "trace_views"]
    out = table(kept[-1], counts, per, unit, args.workload)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
