"""bench_torch.py's serving stages, run in bench.py's order on the CPU at a
toy size (a grid-32 packed field with random weights and the textured
scene's occupancy, a 16x16 test pose, 64^3 and 32^3 bakes): every stage
returns the keys bench.py prints for it, and the run shares its bakes
and frames between stages as bench.py does."""
import math

import pytest
import torch

import bench_torch as bt
from google_nerf_tpu_torch.data.synthetic import analytic_field
from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp

TOY = dict(
    bt.SETTINGS, n_frames=1, bake_res=64, v256_res=32, pad_mult=64,
    mxu=dict(bt.SETTINGS["mxu"], L=32, exact_cull=16, drain_tiles=4,
             drain_L=256, drain_xc=256, max_samples=128),
    v256=dict(bt.SETTINGS["v256"], L=32, exact_cull=16, pbatch=8,
              segment_slots=8, wl_cap=0, drain_tiles=4, drain_L=64,
              drain_xc=64, max_samples=128),
    brick=dict(bt.SETTINGS["brick"], L=64, Lk=16, max_samples=128),
    oneshot=dict(bt.SETTINGS["oneshot"], max_samples=128, chunk=128),
    mixed_bake=dict(bt.SETTINGS["mixed_bake"], vres_fine=64,
                    vres_coarse=32),
    mixed=dict(bt.SETTINGS["mixed"], L=32, exact_cull=16, segment_slots=8,
               wl_cap=0, drain_tiles=4, drain_L=64, drain_xc=64,
               max_samples=128))
# the keys bench.py's stages print (bench.py:262-498), less *_seconds
KEYS = {
    "bake": {"bake_seconds"},
    "mxu": {"render_fps_800_mxu", "render_fps_800_mxu_vs_baseline",
            "render_psnr_800_mxu", "mxu_trunc_tiles", "mxu_pairs_undrained"},
    "mxu_v256": {"render_fps_800_mxu_v256",
                 "render_fps_800_mxu_v256_vs_baseline", "render_fps_800",
                 "render_fps_800_vs_baseline", "render_psnr_800",
                 "mxu_v256_pairs_undrained", "mxu_v256_vs_mxu_mae"},
    "brick": {"render_fps_800_brick", "brick_pairs_dropped",
              "brick_ppr_auto", "brick_vs_mxu_mae"},
    "oneshot": {"render_fps_800_oneshot", "render_psnr_800_oneshot",
                "mxu_vs_oneshot_mae"},
    "baked_oneshot": {"render_fps_800_baked_oneshot", "baked_vs_live_mae"},
    "mixed": {"render_fps_800_mixed", "render_fps_800_mixed_vs_baseline",
              "render_psnr_800_mixed", "mixed_bake_seconds",
              "mixed_bricks_saved_frac", "mixed_dma_slots",
              "mixed_pairs_undrained", "mixed_vs_mxu_mae"},
}


@pytest.fixture(scope="module")
def run():
    model = NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                      packed_log2_size=12, packed_levels=4)
    params = init_ngp(torch.Generator().manual_seed(0), model, "cpu")
    params["packed_table"] *= 1e3
    G = model.grid_size
    c = ((torch.arange(G, dtype=torch.float32) + 0.5) / G * 2 - 1) * 0.5
    xyz = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    occ = (analytic_field(xyz.reshape(-1, 3), "textured")[0] > 1.0).reshape(
        1, G, G, G)
    state = dict(params=params, occ=occ)
    view = bt.serving_view("cpu", 16, 16)
    shared, keys = {}, {}
    for name, fn in bt.STAGES:
        keys[name] = bt.run_stage(name, fn, state, model, view, shared, "cpu",
                                  TOY)
    return keys, shared


@pytest.mark.parametrize("name", [n for n, _ in bt.STAGES])
def test_stage_returns_bench_keys(run, name):
    keys, shared = run
    assert set(keys[name]) == KEYS[name] | {f"{name}_seconds"}
    for k, v in keys[name].items():
        assert isinstance(v, (int, float)) and math.isfinite(v), k
    if name != "bake":
        out = shared["out"][name]
        assert out["rgb"].shape == (16 * 16, 3)
        assert bool(torch.isfinite(out["rgb"]).all())
        assert shared["warm_ms"][name] > 0


def test_stages_share_and_consume_bakes(run):
    keys, shared = run
    # the mixed stage consumed both bakes and padded its pool
    assert "baked" not in shared and "baked256" not in shared
    assert shared["mixed"]["baked"]["n_blocks"] % TOY["pad_mult"] == 0
    assert shared["out"]["oneshot"]["drain_trips"] > 0
    assert keys["mxu"]["mxu_pairs_undrained"] == 0
    assert keys["mxu_v256"]["mxu_v256_vs_mxu_mae"] < 0.05
