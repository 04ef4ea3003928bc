"""Test CLI of the PyTorch port (the port's test.py): load a full or slim
checkpoint, render the test split of any dataset of train_torch.py's
(train_torch.make_dataset, with the same dataset flags), report mean
PSNR and FPS.

    python test_torch.py --root_dir x --dataset_name synthetic \\
        --synthetic_style textured --downsample 4 \\
        --ckpt_path ckpts/synthetic/my_exp/epoch=29 [--renderer fast]

Renderers: oneshot (the default; the segment marcher unless --march
block or block2 on a single-cascade scene), fast (render_test_fast, or
render_test_baked with --bake), brick (the pair renderer over a bake) and brick_mxu (the tile kernels
over a bake); --save_bake/--load_bake write and read the bake.  Every
timed frame ends with torch.cuda.synchronize() on the card; FPS is the
mean over the frames after the first.  Runs on the CUDA card unless
given --platform cpu.  With --num_gpus N under torchrun (one process a
device, as train_torch.py; gloo with --platform cpu) the oneshot and
brick renderers serve each frame's rays sharded over the ranks
(render_test_oneshot_dp, render_brick_dp; every rank gets the whole
frame) and rank 0 alone prints; the other renderers run whole on every
rank.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from google_nerf_tpu_torch.opt import get_opts
from train_torch import build_configs, device_of, make_dataset


def run(hparams):
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.eval.metrics import psnr
    from google_nerf_tpu_torch.models import baked as bk
    from google_nerf_tpu_torch.models.render_brick import (brick_geometry,
                                                           render_brick)
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    from google_nerf_tpu_torch.models.rendering import render_test
    from google_nerf_tpu_torch.ops.grid import (pack_occupancy_blocks,
                                                pack_occupancy_u8)
    from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
    from google_nerf_tpu_torch.ops.march_seg import required_dilation_radius
    from google_nerf_tpu_torch.parallel import comm
    from google_nerf_tpu_torch.parallel.dp import (render_brick_dp,
                                                   render_test_oneshot_dp)
    from google_nerf_tpu_torch.train.system import (block_march,
                                                    init_train_state)
    from google_nerf_tpu_torch.utils.ckpt import load_ckpt_filtered

    dev = device_of(hparams)
    dp = comm.get_world_size() > 1
    say = print if comm.is_main_process() else (lambda *a, **k: None)
    dataset = make_dataset(hparams, 'test', dev)
    cfg = build_configs(hparams)
    m = cfg.model
    full = init_train_state(cfg, dataset.K, dataset.poses, dataset.img_wh,
                            generator=torch.Generator().manual_seed(0),
                            device=dev)
    # prefix-filtered partial load: what the (slim or full) checkpoint
    # holds, fresh values for the rest
    state = load_ckpt_filtered(hparams.ckpt_path, full,
                               include_prefixes=("params", "occ", "step",
                                                 "density_grid"))

    w, h = dataset.img_wh
    renderer = hparams.renderer
    rms = hparams.render_max_samples or cfg.max_samples
    # always repack from the boolean grid (the packed layout is derived
    # data), with radii for the coarsest lattice any renderer here uses
    ms_pack = min(cfg.max_samples, rms)
    occ_u8 = pack_occupancy_u8(
        state["occ"], required_dilation_radius(8, m.grid_size, ms_pack,
                                               m.scale),
        super_radius=required_dilation_radius(32, m.grid_size, ms_pack,
                                              m.scale))
    # the block marchers serve single-cascade scenes: exact-occupancy
    # block rows, no dilation
    serve_march = block_march(cfg)
    if serve_march == "block2":
        occ_oneshot = pack_occupancy_block2(state["occ"], max_samples=rms,
                                            scale=m.scale)
    elif serve_march == "block":
        occ_oneshot = pack_occupancy_blocks(state["occ"])
    else:
        occ_oneshot = occ_u8
    baked = bcfg = None
    if renderer in ("brick", "brick_mxu"):
        if cfg.exp_step_factor != 0.0:
            say("brick renderers target bounded scenes; "
                  "falling back to oneshot")
            renderer = "oneshot"
        else:
            hparams.bake = True
    if hparams.load_bake:
        baked, bcfg = bk.load_baked(hparams.load_bake, device=dev)
        say(f'loaded bake: {baked["n_blocks"]} blocks (pool '
              f'{baked["pool"].nbytes / 2**20:.0f} MiB, {bcfg.dtype})')
    elif hparams.bake:
        bcfg = bk.BakedConfig(voxel_res=hparams.bake_res,
                              dtype=hparams.bake_dtype)
        t0 = time.time()
        baked = bk.bake(state["params"], m, state["occ"], bcfg, device=dev)
        say(f'baked {baked["n_blocks"]} blocks in {time.time()-t0:.1f}s '
              f'(pool {baked["pool"].nbytes / 2**20:.0f} MiB)')
        if hparams.save_bake and comm.is_main_process():
            bk.save_baked(hparams.save_bake, baked, bcfg)
            say(f'saved bake -> {hparams.save_bake}')

    directions = torch.as_tensor(dataset.directions, device=dev)
    poses = torch.as_tensor(dataset.poses, device=dev)
    brick_geo = None
    if renderer in ("brick", "brick_mxu"):
        brick_geo = brick_geometry(baked["block_map"], bcfg, m, dev)
        say(f"brick geometry: {brick_geo[0].shape[0]} bricks")
    if renderer == "brick" and not hparams.brick_ppr:
        # --brick_ppr 0: render pose 0 with a generous budget and size the
        # per-chunk budget off its densest chunk with a 1.25x margin
        ro0, rd0 = get_rays(directions, poses[0])
        probe = render_brick(
            baked, m, ro0, rd0, w, h, bcfg=bcfg, geometry=brick_geo,
            pairs_per_ray=16.0, L=hparams.brick_L, Lk=hparams.brick_Lk,
            macro_tiles=hparams.brick_macro, macro_L=hparams.brick_macro_L,
            max_samples=rms, device=dev)
        n_tiles = ((w + 7) // 8) * ((h + 7) // 8)
        chunk_rays = min(2048, n_tiles) * 8 * 8
        densest = int(probe["pairs_per_chunk"].max())
        hparams.brick_ppr = max(0.5, round(1.25 * densest / chunk_rays, 1))
        say(f'brick auto budget: {int(probe["pairs_total"])} windows '
              f'(densest chunk {densest}/{chunk_rays} rays) -> --brick_ppr '
              f'{hparams.brick_ppr}')

    psnrs, times, frame0 = [], [], {}
    for i in range(len(dataset.poses)):
        rays_o, rays_d = get_rays(directions, poses[i])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        if renderer == "brick_mxu":
            seg = hparams.brick_mxu_seg
            out = render_brick_mxu(
                baked, m, rays_o, rays_d, w, h, bcfg=bcfg,
                T_threshold=hparams.T_threshold, geometry=brick_geo,
                L=hparams.brick_mxu_L, kernel=hparams.brick_mxu_kernel,
                pbatch=hparams.brick_mxu_pbatch,
                exact_cull=hparams.brick_mxu_exact_cull,
                wl_cap=hparams.brick_mxu_wl_cap, segment_slots=seg,
                drain_xc=hparams.brick_mxu_drain_xc,
                bands=("auto" if hparams.brick_mxu_bands and not seg
                       else ()),
                drain_tiles=hparams.brick_mxu_drain,
                macro_tiles=hparams.brick_macro,
                macro_L=hparams.brick_macro_L, max_samples=rms, device=dev)
            tele = ("trunc_tiles", "pairs_rendered", "pairs_undrained")
        elif renderer == "brick":
            out = (render_brick_dp if dp else render_brick)(
                baked, m, rays_o, rays_d, w, h, bcfg=bcfg, T_threshold=1e-2,
                geometry=brick_geo, L=hparams.brick_L, Lk=hparams.brick_Lk,
                pairs_per_ray=hparams.brick_ppr,
                pass_fracs=tuple(hparams.brick_passes or ()),
                drain_frac=hparams.brick_drain,
                macro_tiles=hparams.brick_macro,
                macro_L=hparams.brick_macro_L, max_samples=rms, device=dev)
            tele = ("trunc_tiles", "trunc_rays", "pairs_dropped")
        elif renderer == "oneshot" and cfg.exp_step_factor == 0.0:
            os_kw = dict(
                T_threshold=1e-2, max_samples=rms, march=serve_march,
                k=hparams.oneshot_k, budget_div=hparams.oneshot_budget_div,
                straggler_div=hparams.oneshot_straggler_div,
                drain=hparams.oneshot_drain, passes=hparams.oneshot_passes,
                drain_budget_div=hparams.oneshot_drain_budget_div)
            # compact main: block2 serving with the drain starts from the
            # rays a super scan marks live
            if serve_march == "block2" and os_kw["drain"] \
                    and hparams.oneshot_compact:
                os_kw["compact_main"] = True
            if baked is not None:
                os_kw["apply_fn"] = bk.make_baked_apply(bcfg)
            out = (render_test_oneshot_dp if dp else render_test_oneshot)(
                baked if baked is not None else state["params"], m,
                occ_oneshot, rays_o, rays_d, **os_kw)
            tele = ("drain_trips",) if "drain_trips" in out else ()
        elif baked is not None:
            out = bk.render_test_baked(baked, m, occ_u8, rays_o, rays_d,
                                       bcfg=bcfg, T_threshold=1e-2,
                                       max_samples=cfg.max_samples)
            tele = ()
        elif cfg.exp_step_factor == 0.0:
            out = render_test_fast(state["params"], m, occ_u8, rays_o,
                                   rays_d, T_threshold=1e-2,
                                   max_samples=cfg.max_samples)
            tele = ()
        else:
            out = render_test(state["params"], m, state["occ"], rays_o,
                              rays_d, exp_step_factor=cfg.exp_step_factor,
                              T_threshold=1e-2, max_samples=cfg.max_samples)
            tele = ()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.time() - t0)
        if i == 0 and tele:
            # nonzero trunc/undrained/dropped counts mean content was
            # culled (raise --brick_mxu_drain, --brick_L/--brick_Lk or
            # --brick_ppr)
            frame0 = {k: int(out[k]) for k in tele}
            say(f'{renderer} telemetry (frame 0): ' + ' '.join(
                f'{k}={v}' for k, v in frame0.items()))
        if len(dataset.rays) > 0:
            psnrs.append(float(psnr(out["rgb"], torch.as_tensor(
                dataset.rays[i], device=dev))))
    # the first frame includes the kernel builds and first calls
    steady = times[1:] if len(times) > 1 else times
    fps = 1.0 / np.mean(steady)
    mean_psnr = float(np.mean(psnrs)) if psnrs else float('nan')
    say(f'mean PSNR: {mean_psnr:.2f}, FPS: {fps:.2f} '
          f'({w}x{h}, {len(times)} frames)')
    return dict(psnr=mean_psnr, fps=fps, frame0=frame0)


if __name__ == '__main__':
    run(get_opts())
    from google_nerf_tpu_torch.parallel import comm
    if comm.initialized():
        comm.dist.destroy_process_group()
