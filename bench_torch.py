"""Benchmark of the PyTorch port on one CUDA card: bench.py's training
recipe, then its serving stages on the trained state, in bench.py's order
and with its settings (bench.py:92-498).

    python3 bench_torch.py [--seed N]

Prints one JSON line at the end, with bench.py's keys:
  {"metric": "train_rays_per_sec_per_chip", "value": N, "unit": "rays/s",
   "vs_baseline": N, "extra": {...}}
`extra["device"]` is the card's name and power limit as nvidia-smi gives
them.  vs_baseline compares with the reference's published recipe, as
bench.py does (BASELINE.md).  A stage that fails ends the run with a
nonzero exit; there is no deadline and no skipped stage.  It runs only
on a CUDA card.

The stages are importable functions stage(state, model, view, shared,
device, s) -> keys: `state` holds the trained params and occupancy,
`view` the test pose's rays and ground truth, `shared` what one stage
leaves for the next (bakes, frames, timings), `s` the settings (SETTINGS,
bench.py's; the tests pass toy sizes).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

BASELINE_RAYS_PER_SEC = 30000 * 8192 / 300.0  # 2080 Ti, BASELINE.md
BASELINE_FPS = 32.44                           # 800^2, BASELINE.md

# bench.py:113-117 (its model: bench.py:92-93, see model_config)
TRAIN_KW = dict(batch_size=8192, k_samples=256, num_epochs=30,
                samples_budget=57344, max_samples=512, grid_sample_div=16,
                random_bg=True, exclude_incomplete="backfill",
                march="block2")
MS_RENDER = 512         # bench.py's serving lattice
SETTINGS = dict(
    n_frames=5,
    bake_res=512,
    # bench.py:284-288, tp512
    mxu=dict(L=192, exact_cull=48, kernel="tp", pbatch=8, bands=(),
             segment_slots=8, drain_tiles=256, drain_L=384, drain_xc=384,
             max_samples=min(MS_RENDER, 256), T_threshold=1e-2),
    v256_res=256,
    # bench.py:327-330, the worklist kernel
    v256=dict(L=96, exact_cull=96, kernel="wl", pbatch=16, bands=(),
              segment_slots=32, wl_cap=5120, drain_tiles=64, drain_L=128,
              drain_xc=96, max_samples=min(MS_RENDER, 256),
              T_threshold=1e-2),
    # bench.py:376-380 at its fixed pairs budget, 17.6 pairs a ray
    brick=dict(T_threshold=1e-2, L=256, Lk=24, pairs_per_ray=17.6,
               chunk_tiles=1024, max_samples=MS_RENDER),
    # bench.py:404-409: compact main, block2, drain
    oneshot=dict(T_threshold=1e-2, max_samples=MS_RENDER, k=32,
                 budget_div=0, straggler_div=2, drain=True, march="block2",
                 compact_main=True),
    # bench.py:456-477
    mixed_bake=dict(vres_fine=512, vres_coarse=256, block=8,
                    dtype="bfloat16", tol_sigma=16.0, tol_feat=2.0),
    pad_mult=4096,
    mixed=dict(L=192, exact_cull=96, kernel="wl", pbatch=8, bands=(),
               segment_slots=32, wl_cap=12288, drain_tiles=128,
               drain_L=256, drain_xc=256, max_samples=min(MS_RENDER, 256),
               T_threshold=1e-2),
)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def model_config():
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    return NGPConfig(scale=0.5, encoder="packed", grid_size=128,
                     compute_dtype=torch.bfloat16)


def train_config():
    from google_nerf_tpu_torch.train.system import TrainConfig
    return TrainConfig(model=model_config(), **TRAIN_KW)


@dataclasses.dataclass
class View:
    """One pose's rays (W*H, 3) and ground-truth image (W*H, 3)."""
    rays_o: torch.Tensor
    rays_d: torch.Tensor
    gt: torch.Tensor
    w: int
    h: int


def serving_view(device, w: int = 800, h: int = 800) -> View:
    """bench.py's benched frame: the textured scene's test-split pose."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(w, h),
                          style="textured", device=device)
    o, d = get_rays(torch.as_tensor(ds.directions, device=device),
                    torch.as_tensor(ds.poses[0], device=device))
    return View(o, d, torch.as_tensor(ds.rays[0], device=device), w, h)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_frames(frame, device, n_frames: int):
    """bench.py's rule: one frame, then a warm frame timed alone, then
    n_frames frames (2 if the warm frame took 2 s or more).  Returns
    (frames/s, the last frame's output, warm frame ms)."""
    frame()
    _sync(device)
    t0 = time.time()
    frame()
    _sync(device)
    warm_s = time.time() - t0
    n = n_frames if warm_s < 2.0 else 2
    t0 = time.time()
    outs = [frame() for _ in range(n)]
    _sync(device)
    return n / (time.time() - t0), outs[-1], 1e3 * warm_s


def _psnr(rgb, view) -> float:
    from google_nerf_tpu_torch.eval.metrics import psnr
    return round(float(psnr(rgb, view.gt)), 2)


def _mae(a, b) -> float:
    return round(float((a - b).abs().mean()), 4)


def _serve(name, frame, shared, device, s):
    """Time a stage's frame; keep the frame function, its last output and
    its warm frame ms in `shared` under the stage's name."""
    fps, out, warm_ms = time_frames(frame, device, s["n_frames"])
    shared.setdefault("frames", {})[name] = frame
    shared.setdefault("out", {})[name] = out
    shared.setdefault("warm_ms", {})[name] = warm_ms
    return fps, out


def stage_bake(state, model, view, shared, device, s=SETTINGS):
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    bcfg = BakedConfig(voxel_res=s["bake_res"], block=8, dtype="bfloat16")
    t0 = time.time()
    shared["baked"] = bake(state["params"], model, state["occ"], bcfg,
                           device=device)
    _sync(device)
    shared["bcfg"] = bcfg
    return {"bake_seconds": round(time.time() - t0, 1)}


def stage_mxu(state, model, view, shared, device, s=SETTINGS):
    """K2 (tp) on the full-resolution bake, exact by construction."""
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    shared["geo"] = brick_geometry(shared["baked"]["block_map"],
                                   shared["bcfg"], model)

    def frame():
        return render_brick_mxu(shared["baked"], model, view.rays_o,
                                view.rays_d, view.w, view.h,
                                bcfg=shared["bcfg"], geometry=shared["geo"],
                                device=device, **s["mxu"])
    fps, out = _serve("mxu", frame, shared, device, s)
    return {"render_fps_800_mxu": round(fps, 2),
            "render_fps_800_mxu_vs_baseline": round(fps / BASELINE_FPS, 3),
            "render_psnr_800_mxu": _psnr(out["rgb"], view),
            "mxu_trunc_tiles": int(out["trunc_tiles"]),
            "mxu_pairs_undrained": int(out["pairs_undrained"])}


def stage_mxu_v256(state, model, view, shared, device, s=SETTINGS):
    """K1 (the global worklist) on the half-resolution bake: the
    headline serving keys."""
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    bc = BakedConfig(voxel_res=s["v256_res"], block=8, dtype="bfloat16")
    baked = bake(state["params"], model, state["occ"], bc, device=device)
    geo = brick_geometry(baked["block_map"], bc, model)
    shared["baked256"], shared["bc256"] = baked, bc

    def frame():
        return render_brick_mxu(shared["baked256"], model, view.rays_o,
                                view.rays_d, view.w, view.h, bcfg=bc,
                                geometry=geo, device=device, **s["v256"])
    fps, out = _serve("mxu_v256", frame, shared, device, s)
    kv = {"render_fps_800_mxu_v256": round(fps, 2),
          "render_fps_800_mxu_v256_vs_baseline": round(fps / BASELINE_FPS,
                                                       3),
          "render_fps_800": round(fps, 2),
          "render_fps_800_vs_baseline": round(fps / BASELINE_FPS, 3),
          "render_psnr_800": _psnr(out["rgb"], view),
          "mxu_v256_pairs_undrained": int(out["pairs_undrained"])}
    if "mxu" in shared["out"]:
        kv["mxu_v256_vs_mxu_mae"] = _mae(out["rgb"],
                                         shared["out"]["mxu"]["rgb"])
    return kv


def stage_brick(state, model, view, shared, device, s=SETTINGS):
    """The pair renderer (no kernel) on the full-resolution bake."""
    from google_nerf_tpu_torch.models.render_brick import render_brick

    def frame():
        return render_brick(shared["baked"], model, view.rays_o, view.rays_d,
                            view.w, view.h, bcfg=shared["bcfg"],
                            geometry=shared["geo"], device=device,
                            **s["brick"])
    fps, out = _serve("brick", frame, shared, device, s)
    kv = {"render_fps_800_brick": round(fps, 2),
          "brick_pairs_dropped": int(out["pairs_dropped"]),
          "brick_ppr_auto": s["brick"]["pairs_per_ray"]}
    if "mxu" in shared["out"]:
        kv["brick_vs_mxu_mae"] = _mae(out["rgb"], shared["out"]["mxu"]["rgb"])
    return kv


def stage_oneshot(state, model, view, shared, device, s=SETTINGS):
    """The live field (its encoder's gather on P2) through the one-shot
    renderer: the reference of mxu_vs_oneshot_mae."""
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
    occ_render = pack_occupancy_block2(
        state["occ"], max_samples=s["oneshot"]["max_samples"],
        scale=model.scale)

    def frame(apply_fn=None, p=None):
        return render_test_oneshot(
            state["params"] if p is None else p, model, occ_render,
            view.rays_o, view.rays_d, apply_fn=apply_fn, **s["oneshot"])
    shared["oneshot_frame"] = frame
    fps, out = _serve("oneshot", frame, shared, device, s)
    kv = {"render_fps_800_oneshot": round(fps, 2),
          "render_psnr_800_oneshot": _psnr(out["rgb"], view)}
    if "mxu" in shared["out"]:
        kv["mxu_vs_oneshot_mae"] = _mae(shared["out"]["mxu"]["rgb"],
                                        out["rgb"])
    return kv


def stage_baked_oneshot(state, model, view, shared, device, s=SETTINGS):
    """The one-shot renderer over the full-resolution baked field."""
    from google_nerf_tpu_torch.models.baked import make_baked_apply
    baked_fn = make_baked_apply(shared["bcfg"])
    fps, out = _serve("baked_oneshot", lambda: shared["oneshot_frame"](
        apply_fn=baked_fn, p=shared["baked"]), shared, device, s)
    return {"render_fps_800_baked_oneshot": round(fps, 2),
            "baked_vs_live_mae": _mae(out["rgb"],
                                      shared["out"]["oneshot"]["rgb"])}


def stage_mixed(state, model, view, shared, device, s=SETTINGS):
    """The mixed-resolution bake from the two bakes (which it consumes),
    padded to a brick multiple, through K1."""
    from google_nerf_tpu_torch.models.baked_mixed import (bake_mixed,
                                                          pad_bricks)
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    t0 = time.time()
    baked, bc, geo, stats = bake_mixed(
        state["params"], model, state["occ"], fine=shared.pop("baked"),
        coarse=shared.pop("baked256"), device=device, **s["mixed_bake"])
    shared.pop("geo", None)
    baked, geo = pad_bricks(baked, geo, s["pad_mult"])
    _sync(device)
    t_bake = time.time() - t0
    shared["mixed"] = dict(baked=baked, geo=geo, stats=stats)

    def frame():
        return render_brick_mxu(baked, model, view.rays_o, view.rays_d,
                                view.w, view.h, bcfg=bc, geometry=geo,
                                device=device, **s["mixed"])
    fps, out = _serve("mixed", frame, shared, device, s)
    kv = {"render_fps_800_mixed": round(fps, 2),
          "render_fps_800_mixed_vs_baseline": round(fps / BASELINE_FPS, 3),
          "render_psnr_800_mixed": _psnr(out["rgb"], view),
          "mixed_bake_seconds": round(t_bake, 1),
          "mixed_bricks_saved_frac": stats["bricks_saved_frac"],
          "mixed_dma_slots": int(out["dma_slots"]),
          "mixed_pairs_undrained": int(out["pairs_undrained"])}
    if "mxu" in shared["out"]:
        kv["mixed_vs_mxu_mae"] = _mae(out["rgb"], shared["out"]["mxu"]["rgb"])
    return kv


# bench.py's stage order
STAGES = (("bake", stage_bake), ("mxu", stage_mxu),
          ("mxu_v256", stage_mxu_v256), ("brick", stage_brick),
          ("oneshot", stage_oneshot), ("baked_oneshot", stage_baked_oneshot),
          ("mixed", stage_mixed))


def run_stage(name, fn, state, model, view, shared, device, s=SETTINGS):
    """One stage's keys plus `<name>_seconds`, as bench.py's stage()."""
    t0 = time.time()
    kv = fn(state, model, view, shared, device, s)
    kv[f"{name}_seconds"] = round(time.time() - t0, 1)
    return kv


def train(seed: int, device):
    """bench.py's training: 384 warmup steps, 128 provisional, then steps
    512-1023 timed (the grid cadence included).  Returns (state, cfg,
    headline keys)."""
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.train import system as tsys
    t_wall0 = time.time()
    cfg = train_config()
    ds = SyntheticDataset(split="train", n_images=40, img_wh=(256, 256),
                          style="textured", device=device)
    scene = ds.scene()
    state = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                                  generator=torch.Generator().manual_seed(
                                      seed), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loop(n):
        _, metrics = tsys.run_training(state, scene, cfg, steps=n,
                                       generator=gen)
        _sync(device)
        return metrics

    loop(384)
    t_warm = time.time() - t_wall0
    t0 = time.time()
    loop(128)
    prov = 128 * cfg.batch_size / (time.time() - t0)
    t0 = time.time()
    metrics = loop(512)
    dt = time.time() - t0
    rays_per_sec = 512 * cfg.batch_size / dt
    return state, cfg, dict(
        value=round(rays_per_sec, 1),
        vs_baseline=round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        extra={"steady_state_steps_per_sec": round(512 / dt, 2),
               "train_psnr_at_1024_steps": round(float(metrics["psnr"]), 2),
               "s_per_ray": round(float(metrics["s_per_ray"]), 2),
               "mask_frac": round(float(metrics["mask_frac"]), 3),
               "warmup_seconds": round(t_warm, 1),
               "provisional_rays_per_sec": round(prov, 1)})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device; this benchmark runs "
                         "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_wall0 = time.time()
    dev = torch.device("cuda")
    state, cfg, head = train(args.seed, dev)
    head["extra"]["device"] = card_line()
    view = serving_view(dev)
    shared = {}
    for name, fn in STAGES:
        head["extra"].update(run_stage(name, fn, state, cfg.model, view,
                                       shared, dev))
    head["extra"]["total_seconds"] = round(time.time() - t_wall0, 1)
    print(json.dumps({"metric": "train_rays_per_sec_per_chip",
                      "value": head["value"], "unit": "rays/s",
                      "vs_baseline": head["vs_baseline"],
                      "extra": head["extra"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
