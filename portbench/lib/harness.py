"""The harness: finds a cell's configuration, traffic, limits, runner
and metric readers by name under the checkout, runs the runner, reads
the metrics, judges `correct` against the limits, checks that no JAX
module was loaded, and prints the result line.

Nothing here names a particular cell: a configuration is
`configs/<name>.json` (named by BENCHMARK.json), a traffic mix
`traffic/<traffic>.json`, whose "runner" names `runners/<runner>.py`,
the limits of a cell `limits/<workload>.json`, and a metric
`metrics/<metric name>.py` with a `read(run)` function.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "google_nerf_tpu")
BENCH_DIR = "portbench"


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with everything found for it."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; "
                             f"BENCHMARK.json has {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = confs[self.entry["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(self.dir / "traffic"
                                 / f"{self.entry['traffic']}.json")
        lim = self.dir / "limits" / f"{workload}.json"
        self.limits = load_json(lim) if lim.exists() else {}
        self.chips = int(self.entry["chips"])

    @property
    def dir(self) -> Path:
        return self.root / BENCH_DIR

    def runner(self):
        name = self.traffic["runner"]
        return load_module(self.dir / "runners" / f"{name}.py",
                           f"portbench_runner_{name}")

    def metrics(self, trace: bool):
        """The metric entries this cell reports in this mode."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric.replace('.', '_')}")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or its package's,
    compared whole (google_nerf_tpu_torch is not google_nerf_tpu)."""
    mods = sys.modules if modules is None else modules
    tops = {m.split(".")[0] for m in mods}
    return sorted(t for t in tops if t in FORBIDDEN)


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """correct, and the compared numbers {name: {value, limit}}: every
    number with a limit must be finite and at most its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok and bool(limits), out


def read_metrics(cell: Cell, run: Dict, trace: bool, required: bool):
    """{name: {value, unit}} of the cell's metrics in this mode; an
    end-to-end metric that cannot be read is an error."""
    out = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(run)
        if v is None:
            if required:
                raise RuntimeError(f"metric {m['name']} has nothing to "
                                   f"read in {cell.name}")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, *, device: str = "cuda", overrides: Optional[Dict]
            = None, fault: Optional[str] = None, control: bool = False,
            readings: Optional[Dict] = None):
    """One run of a cell: the runner's run, then its metrics and
    verdict.  Returns the result dict of the last line; `readings`, if
    given, receives every number the runner read, limited or not."""
    cell = Cell(root, workload)
    if overrides:
        for key in ("model", "recipe", "traffic"):
            if key in overrides:
                tgt = (cell.config["model"] if key == "model" else
                       cell.traffic.get("recipe", {}) if key == "recipe"
                       else cell.traffic)
                tgt.update(overrides[key])
    run = cell.runner().run(cell, seed=seed, seconds=seconds, trace=trace,
                            device=device, fault=fault, control=control)
    if readings is not None:
        readings.update(run["readings"])
    correct, compared = judge(run["readings"], cell.limits)
    metrics = ({} if run.get("metrics_skip") else
               read_metrics(cell, run, trace, required=not trace))
    res = dict(correct=correct, attempted=run["attempted"],
               failed=run["failed"], metrics=metrics, device=run["device"])
    if trace and run.get("breakdown"):
        res["breakdown"] = run["breakdown"]
    res["compared"] = compared
    return res
