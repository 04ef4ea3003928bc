"""The benchmark's harness on the CPU: cells, configurations, traffic,
limits and metrics found by name; the traffic's determinism per seed;
the yardstick's byte and operation counts on hand-worked shapes; the
trace reduction on a synthetic trace; the result line's keys; and the
import rules (no JAX anywhere, nothing of the program in the
reference).

    python -m pytest portbench/tests -q
"""
import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import harness, scene, trace, work  # noqa: E402
from portbench.reference import field as rf  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(ROOT, name)
    assert cell.config["name"] == cell.entry["config"]
    assert (cell.dir / "runners" / f"{cell.traffic['runner']}.py").exists()
    assert cell.limits, "every cell has its limits file"
    for trace_mode in (False, True):
        ms = cell.metrics(trace_mode)
        assert ms, (name, trace_mode)
        for m in ms:
            assert hasattr(cell.reader(m["name"]), "read")
    assert "setup_s" in [m["name"] for m in cell.metrics(False)]


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_new_traffic_file_is_found_without_edits(tmp_path):
    """A later cell is a traffic file and an entry: no harness edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    t = json.loads((ROOT / "portbench/traffic/train_2e18.json").read_text())
    t["setup_steps"] = 64
    (tmp_path / "portbench/traffic/train_short.json").write_text(
        json.dumps(t))
    bench["workloads"].append(dict(
        name="ngp_packed_s05.train_short", config="ngp_packed_s05",
        traffic="train_short", chips=1, why="a test cell"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(tmp_path, "ngp_packed_s05.train_short")
    assert cell.traffic["setup_steps"] == 64
    assert cell.runner().run
    # a cell without its own limits file judges nothing as correct
    assert cell.limits == {}
    assert harness.judge({"x": 0.0}, cell.limits)[0] is False
    for p, b in before.items():
        assert p.read_bytes() == b


def test_params_are_deterministic_per_seed():
    spec = rf.field_spec(harness.load_json(
        ROOT / "portbench/configs/ngp_packed_s05.json")["model"])
    spec = rf.FieldSpec(**{**spec.__dict__, "log2_table": 8})
    a = rf.make_params(spec, 2 ** 31 + 17, "cpu")
    b = rf.make_params(spec, 2 ** 31 + 17, "cpu")
    c = rf.make_params(spec, 2 ** 31 + 18, "cpu")
    for k, v in rf.leaves(a).items():
        assert torch.equal(v, rf.leaves(b)[k])
        assert not torch.equal(v, rf.leaves(c)[k])
    assert float(a["table"].abs().max()) <= 1e-4


def test_serving_traffic_is_deterministic_per_seed():
    from portbench.runners import serve_oneshot as so

    def sample(seed, n):
        r = so.Reservoir(seed, 3)
        for i in range(n):
            r.offer(i, lambda: i)
        return list(r.views())

    seeds = [3, 2 ** 31 + 5, 2 ** 33]
    for s in seeds:
        assert so.start_pose(s, 24) == so.start_pose(s, 24)
        assert so.control_views(s, 3, 8) == so.control_views(s, 3, 8)
        # the sample is drawn from the views the window finished: as
        # many whatever their number, each one of them
        for n in (3, 41, 117):
            got = sample(s, n)
            assert got == sample(s, n) and len(got) == 3
            assert all(0 <= v < n for v in got)
    # every view is drawn about as often (Algorithm R is uniform)
    hits = [0] * 10
    for s in range(3000):
        for v in sample(s, 10):
            hits[v] += 1
    assert min(hits) > 0.8 * 900 and max(hits) < 1.2 * 900
    # every seed serves the same poses: only the start moves
    assert len({so.start_pose(s, 24) for s in range(100)}) > 10


def test_surface_field_is_opaque_inside_and_clear_outside():
    """The served field's density follows the scene's solid: sigma * dt
    far above 1 at the solid's vertices of the surface level, far below
    it away from the scene; the same seed gives the same weights."""
    from portbench.lib import surface
    spec = rf.field_spec(harness.load_json(
        ROOT / "portbench/configs/ngp_hash_s05.json")["model"])
    spec = rf.FieldSpec(**{**spec.__dict__, "log2_table": 15,
                           "n_levels": 4,
                           "resolutions": spec.resolutions[:4]})
    kw = dict(gain=60.0, iso=0.5, max_samples=512)
    a = surface.surface_params(spec, 2 ** 31 + 3, "cpu", **kw)
    b = surface.surface_params(spec, 2 ** 31 + 3, "cpu", **kw)
    for k, v in rf.leaves(a).items():
        assert torch.equal(v, rf.leaves(b)[k])
    lv = surface.surface_level(spec)
    r = spec.resolutions[lv]
    assert (r + 1) ** 3 <= spec.table_rows
    f = rf.Field(spec, a, rf.Precision())
    dt = 3 ** 0.5 / 512
    c = torch.arange(r + 1)
    v = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    x = (v.float() / r * 2 - 1) * spec.scale
    solid = scene.analytic_field(x)[0] > 1.0
    # vertices whose neighbours are all solid or all clear
    g = solid.reshape(r + 1, r + 1, r + 1).float()
    pool = torch.nn.functional.max_pool3d
    inner = (-pool(-g[None, None], 3, 1, 1))[0, 0].reshape(-1) > 0.5
    outer = pool(g[None, None], 3, 1, 1)[0, 0].reshape(-1) < 0.5
    assert inner.sum() > 0 and outer.sum() > 0
    assert float(f.density(x[inner]).min()) * dt > 1e3
    assert float(f.density(x[outer]).max()) * dt < 1e-6


def test_training_scene_is_fixed():
    a = scene.training_scene(2, 16, 16, "cpu")
    b = scene.training_scene(2, 16, 16, "cpu")
    assert torch.equal(a["images"], b["images"])
    assert a["images"].shape == (2, 256, 3)
    assert 0.0 < float(a["alphas"].mean()) < 1.0


def test_encoder_bytes_and_mlp_flops_by_hand():
    packed = rf.field_spec(harness.load_json(
        ROOT / "portbench/configs/ngp_packed_s05.json")["model"])
    hashf = rf.field_spec(harness.load_json(
        ROOT / "portbench/configs/ngp_hash_s05.json")["model"])
    n = 1000
    # packed: 8 levels, rows of 8 corners x 2 bf16 = 32 bytes, an int32
    # index each; 16 f32 features out
    assert work.encoder_forward_bytes(packed, n, "bfloat16") == \
        n * 8 * (32 + 4) + n * 16 * 4
    # hash: 16 levels x 8 corners, rows of 2 bf16 = 4 bytes
    assert work.encoder_forward_bytes(hashf, n, "bfloat16") == \
        n * 16 * 8 * (4 + 4) + n * 32 * 4
    # backward: feature gradient and indices in, the f32 table out
    assert work.encoder_backward_bytes(packed, n) == \
        n * 16 * 4 + n * 8 * 4 + 8 * 2 ** 16 * 16 * 4
    assert work.encoder_backward_bytes(hashf, n) == \
        n * 32 * 4 + n * 128 * 4 + 16 * 2 ** 19 * 2 * 4
    # MLP MACs a sample: sigma 16x64 + 64x16, rgb 32x64 + 64x64 + 64x3
    assert rf.mlp_macs(packed) == 16 * 64 + 64 * 16 + 32 * 64 + 64 * 64 \
        + 64 * 3 == 8384
    assert rf.mlp_macs(hashf) == 9408
    assert work.train_step_flops(packed, 2 ** 18) == 6 * 8384 * 2 ** 18
    assert math.isclose(work.train_step_flops(packed, 2 ** 18) / 1e9,
                        13.19, rel_tol=1e-3)
    assert work.density_flops(packed, 10) == 2 * (16 * 64 + 64 * 16) * 10
    t, by = work.bound_s(3.35e12)
    assert math.isclose(t, 1.0) and by == "bytes"
    t, by = work.bound_s(0, 67e12, "float32")
    assert math.isclose(t, 1.0) and by == "operations"
    assert work.peak_flops("bfloat16") == 989e12
    assert work.peak_flops("float32", tf32=True) == 495e12


def test_level_resolutions():
    assert rf.level_resolutions(16, 16, 1024)[0] == 16
    assert rf.level_resolutions(16, 16, 1024)[-1] in (1023, 1024)
    assert rf.level_resolutions(2, 16, 64) == [16, 64]


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """A 100 us window: two kernels (10-30, 25-45: union 35 us) and a
    memset (70-80), launched by three runtime calls, two of them inside
    an encoder range; one launch outside the window."""
    return [
        _ev("portbench.window", "user_annotation", 0, 100),
        _ev("enc", "user_annotation", 5, 20),
        _ev("aten::mul", "cpu_op", 40, 30),
        _ev("cudaLaunchKernel", "cuda_runtime", 6, 2, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 8, 2, corr=2),
        _ev("cudaMemsetAsync", "cuda_runtime", 50, 2, corr=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 150, 2, corr=4),
        _ev("k1", "kernel", 10, 20, tid=7, corr=1),
        _ev("k2", "kernel", 25, 20, tid=7, corr=2),
        _ev("Memset", "gpu_memset", 70, 10, tid=7, corr=3),
        _ev("k3", "kernel", 160, 5, tid=7, corr=4),
    ]


def test_trace_reduction_by_hand():
    t = trace.Trace(synthetic_trace(), "portbench.window")
    assert math.isclose(t.window_s, 100e-6)
    assert math.isclose(t.busy_s, 45e-6)
    assert math.isclose(1 - t.busy_s / t.window_s, 0.55)
    assert t.launches() == 3
    enc = t.launched_in(t.ranges("enc"))
    assert sorted(e["name"] for e in enc) == ["k1", "k2"]
    assert math.isclose(t.device_seconds(enc), 35e-6)
    top = dict(t.top_ops())
    assert math.isclose(top["k1"], 20e-6) and "k3" not in top
    gaps = t.idle_gaps()
    assert math.isclose(gaps[0][1], 25e-6) and gaps[0][0] == "aten::mul"
    assert math.isclose(sum(g for _, g in gaps), 55e-6)


def test_union_length():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([]) == 0


def test_forbidden_modules_compare_whole_names():
    mods = {"google_nerf_tpu_torch": 1, "google_nerf_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "google_nerf_tpu.ops": 1})
    assert harness.forbidden_modules(mods) == ["google_nerf_tpu", "jax"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax():
    files = list((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        tops = set(_imports(f))
        assert not tops & set(harness.FORBIDDEN), f


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "portbench" / "reference").rglob("*.py"):
        tops = set(_imports(f))
        assert "google_nerf_tpu_torch" not in tops, f
        assert tops <= {"__future__", "contextlib", "dataclasses", "math",
                        "typing", "numpy", "torch", "portbench"}, (f, tops)
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), f


def test_run_refuses_without_a_card(tmp_path):
    """No result line and a nonzero exit where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ cannot run."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
