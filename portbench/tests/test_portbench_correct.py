"""`correct` at a size a test run holds, on the CPU: sound runs of the
program pass the cells' limits; the lower-precision control in the
program's place and each fault the cell can have, planted in the timed
path, come out not correct.  The whole run is driven (set-up, window,
metrics, reference) past the harness's look for a card.

The hash cells' control is TF32, which only the card has: those cases
are marked cuda and decide inside the test.
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import harness  # noqa: E402

# toy sizes: the cells' widths kept where the CPU allows, their tables,
# grid and batch cut; the march group block2 derives for them
TRAIN = dict(
    model=dict(grid_size=16, packed_levels=2, packed_log2_size=8,
               num_levels=2, log2_hashmap_size=8),
    recipe=dict(batch_size=256, samples_budget=2048, k_samples=64,
                max_samples=64, march_group=8, march_keep_groups=32,
                grid_update_interval=4, warmup_steps=16),
    traffic=dict(scene=dict(views=4, width=32, height=32), setup_steps=20,
                 trace_steps=4))
SERVE = dict(
    model=dict(grid_size=16, num_levels=2, log2_hashmap_size=8),
    traffic=dict(view=dict(width=48, height=48),
                 settings=dict(k=32, max_samples=64, T_threshold=0.01,
                               budget_div=0, straggler_div=2, drain=True,
                               march="block2", compact_main=True,
                               chunk=1024),
                 march_group=8, check=dict(views=2),
                 trace_views=2))
TRAIN_CELLS = ["ngp_packed_s05.train_2e18", "ngp_hash_s05.train_2e18"]
SERVE_CELL = "ngp_hash_s05.serve_oneshot_800"
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, trace=False, **kw):
    ov = SERVE if "serve" in cell else TRAIN
    harness.T0 = None
    return harness.execute(ROOT, cell, SEED, 0.5, trace, device="cpu",
                           overrides=ov, **kw)


@pytest.mark.parametrize("cell", TRAIN_CELLS + [SERVE_CELL])
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + [SERVE_CELL])
def test_traced_run_reads_per_layer_metrics(cell):
    res = run(cell, trace=True)
    assert res["correct"], res["compared"]
    names = set(res["metrics"])
    e2e = {m["name"] for m in harness.load_json(
        ROOT / "BENCHMARK.json")["end_to_end"]}
    assert names and not names & e2e
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_packed_control_is_not_correct():
    res = run("ngp_packed_s05.train_2e18", control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ngp_hash_s05.train_2e18", SERVE_CELL])
def test_tf32_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    ov = SERVE if "serve" in cell else TRAIN
    harness.T0 = None
    res = harness.execute(ROOT, cell, SEED, 0.5, False, device="cuda",
                          overrides=ov, control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered",
                                   "grid_frozen"])
def test_training_faults_are_not_correct(cell, fault):
    res = run(cell, fault=fault)
    assert not res["correct"], (fault, res["compared"])


@pytest.mark.parametrize("fault", ["half_rays", "altered"])
def test_serving_faults_are_not_correct(fault):
    res = run(SERVE_CELL, fault=fault)
    assert not res["correct"], (fault, res["compared"])
