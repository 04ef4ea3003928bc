"""Training CLI of the PyTorch port (the port's train.py).

Pipeline: a dataset (nsvf, colmap, nerfpp, rtmv, scannet or the
procedural synthetic scene, through the port's loaders) -> the scene on
the device -> fused train steps with the density-grid cadence -> full
and slim checkpoints -> validation renders (render_test_fast;
render_test where the step is not constant) with PSNR/SSIM(/LPIPS) and
PNGs.

    python train_torch.py --root_dir data/Synthetic_NeRF/Lego \\
        --exp_name lego
    python train_torch.py --root_dir data/360_v2/garden \\
        --dataset_name colmap --scale 4.0 --downsample 0.25
    python train_torch.py --root_dir x --dataset_name synthetic \\
        --synthetic_style textured --downsample 4 --exp_name my_exp

Runs on the CUDA card unless given --platform cpu.  Data-parallel
training over several cards (ROADMAP item 21) raises.  The test video
of a Synthetic NSVF scene is not encoded (no mp4 encoder in the port):
its PNG frames stay, with the warning train.py prints when imageio or
ffmpeg is missing.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from google_nerf_tpu_torch.opt import get_opts


def device_of(hparams) -> torch.device:
    """--platform cpu runs on the CPU; otherwise the CUDA card, which
    must be there.  One device: several cards are ROADMAP item 21."""
    n = hparams.num_gpus
    if hparams.platform == "cpu":
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --platform cpu to run on the "
                           "CPU")
    else:
        dev = torch.device("cuda")
    if n > 1 or (n == -1 and dev.type == "cuda"
                 and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"--num_gpus {n}: several cards (data-parallel training and "
            "serving) are ROADMAP item 21; the port runs on one device")
    return dev


def dataset_kwargs(hparams):
    kwargs = {}
    if hparams.dataset_name == 'synthetic':
        kwargs.update(style=hparams.synthetic_style)
    if hparams.dataset_name == 'scannet':
        kwargs.update(test_skip=hparams.test_skip,
                      rot_transpose=hparams.rot_transpose,
                      scale_flip=hparams.scale_flip,
                      raw_scan_rootdir=hparams.raw_scan_rootdir,
                      depth_dir=hparams.depth_dir)
    return kwargs


def make_dataset(hparams, split: str, device):
    from google_nerf_tpu_torch.data import dataset_dict
    return dataset_dict[hparams.dataset_name](
        hparams.root_dir, split=split, downsample=hparams.downsample,
        device=str(device), **dataset_kwargs(hparams))


def save_videos(val_dir, fps=30):
    """train.py's video export: it writes rgb.mp4 and depth.mp4 through
    imageio and ffmpeg, and prints a warning and keeps the PNG frames
    where they are missing.  The port has no mp4 encoder, so it always
    takes that branch."""
    print(f'[warn] video export skipped: no mp4 encoder in the port '
          f'({fps} fps asked); the PNG frames stay in {val_dir}')


def build_configs(hparams, scene_scale=None):
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    from google_nerf_tpu_torch.train.system import TrainConfig

    scale = hparams.scale if scene_scale is None else scene_scale
    model = NGPConfig(
        scale=scale, encoder=hparams.xyz_encoder,
        num_levels=hparams.num_levels,
        log2_hashmap_size=hparams.log2_hashmap_size,
        packed_levels=hparams.packed_levels,
        packed_log2_size=hparams.packed_log2_size,
        grid_size=hparams.grid_size,
        compute_dtype=torch.bfloat16 if hparams.bf16 else torch.float32)
    exp_step_factor = (1 / 256 if hparams.dataset_name in
                       ('colmap', 'nerfpp') else 0.0)
    budget = hparams.samples_budget
    if budget < 0:
        budget = 16 * hparams.batch_size
    return TrainConfig(
        model=model, lr=hparams.lr, num_epochs=hparams.num_epochs,
        steps_per_epoch=hparams.steps_per_epoch,
        batch_size=hparams.batch_size, k_samples=hparams.k_samples,
        max_samples=hparams.max_samples,
        exp_step_factor=exp_step_factor,
        optimize_ext=hparams.optimize_ext,
        lambda_depth=hparams.depth_loss_w,
        samples_budget=budget,
        random_bg=hparams.random_bg,
        random_bg_per_ray=not hparams.random_bg_per_batch,
        exclude_incomplete=hparams.exclude_incomplete,
        march=hparams.march, block_group=hparams.block_group,
        n_keep_groups=hparams.n_keep_groups,
        n_keep=hparams.n_keep, n_keep_sup=hparams.n_keep_sup,
        weight_decay=hparams.weight_decay,
        grid_sample_div=hparams.grid_sample_div,
        erode=hparams.dataset_name == 'colmap')


def serving_words(state, cfg):
    """The fast renderer's segment word grid: the state's own where it
    holds that layout, else packed from the boolean grid (segments of
    8, super-segments of 32)."""
    from google_nerf_tpu_torch.ops.grid import pack_occupancy_u8
    from google_nerf_tpu_torch.ops.march_seg import required_dilation_radius
    occ_u8 = state["occ_u8"]
    if not isinstance(occ_u8, dict) and occ_u8.ndim == 4:
        return occ_u8
    m = cfg.model
    return pack_occupancy_u8(
        state["occ"],
        required_dilation_radius(8, m.grid_size, cfg.max_samples, m.scale),
        super_radius=required_dilation_radius(32, m.grid_size,
                                              cfg.max_samples, m.scale))


@torch.no_grad()
def validate(hparams, cfg, state, test_dataset, val_dir=None):
    """Render every test view; mean PSNR/SSIM(/LPIPS) over them."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.eval.metrics import LPIPS, psnr, ssim
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    from google_nerf_tpu_torch.models.rendering import render_test
    from google_nerf_tpu_torch.train.system import refined_poses
    from google_nerf_tpu_torch.utils.image import depth2img, write_png

    dev = state["occ"].device
    w, h = test_dataset.img_wh
    lpips = (LPIPS(hparams.lpips_weights, device=dev) if hparams.eval_lpips
             else None)
    directions = torch.as_tensor(test_dataset.directions, device=dev)
    poses = torch.as_tensor(test_dataset.poses, device=dev)
    occ_u8 = serving_words(state, cfg)
    logs = {"psnr": [], "ssim": [], "lpips": []}
    for i in range(len(test_dataset.poses)):
        pose = poses[i]
        if hparams.optimize_ext and "dR" in state["params"]:
            pose = refined_poses(state["params"], pose[None],
                                 torch.tensor([i], device=dev))[0]
        rays_o, rays_d = get_rays(directions, pose)
        if cfg.exp_step_factor == 0.0:
            out = render_test_fast(state["params"], cfg.model, occ_u8,
                                   rays_o, rays_d,
                                   max_samples=cfg.max_samples)
        else:
            out = render_test(state["params"], cfg.model, state["occ"],
                              rays_o, rays_d,
                              exp_step_factor=cfg.exp_step_factor,
                              max_samples=cfg.max_samples)
        rgb_pred = out["rgb"].reshape(h, w, 3)
        if len(test_dataset.rays) > 0:
            rgb_gt = torch.as_tensor(test_dataset.rays[i],
                                     device=dev).reshape(h, w, 3)
            logs["psnr"].append(float(psnr(rgb_pred, rgb_gt)))
            logs["ssim"].append(float(ssim(rgb_pred, rgb_gt)))
            if lpips is not None and lpips.available:
                logs["lpips"].append(float(lpips(rgb_pred, rgb_gt)))
        if val_dir:
            rgb8 = (rgb_pred.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
            write_png(os.path.join(val_dir, f'{i:03d}.png'), rgb8)
            write_png(os.path.join(val_dir, f'{i:03d}_d.png'),
                      depth2img(out["depth"].reshape(h, w).cpu().numpy()))
    return {k: float(np.mean(v)) for k, v in logs.items() if v}


def main(hparams, video_fps=30):
    """Train (or, with --val_only, validate a checkpoint); returns the
    validation logs, with the net-of-warm-up training time and rate."""
    from google_nerf_tpu_torch.train.system import (fused_train_step,
                                                    grid_update_step,
                                                    init_train_state,
                                                    pack_marching_grid)
    from google_nerf_tpu_torch.utils.ckpt import (load_ckpt, save_ckpt,
                                                  save_slim_ckpt)
    from google_nerf_tpu_torch.utils.logging import (ScalarLogger,
                                                     TrainingStats,
                                                     debug_mode,
                                                     profile_trace)

    dev = device_of(hparams)
    if hparams.debug_nans:
        debug_mode(nans=True)
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError('You need to provide a @ckpt_path for validation!')

    train_dataset = make_dataset(hparams, hparams.split, dev)
    test_dataset = make_dataset(hparams, 'test', dev)
    cfg = build_configs(hparams)
    ckpt_dir = os.path.abspath(
        f'ckpts/{hparams.dataset_name}/{hparams.exp_name}')
    os.makedirs(ckpt_dir, exist_ok=True)
    val_dir = None
    if not hparams.no_save_test:
        val_dir = os.path.abspath(
            f'results/{hparams.dataset_name}/{hparams.exp_name}')
        os.makedirs(val_dir, exist_ok=True)

    state = init_train_state(
        cfg, train_dataset.K, train_dataset.poses, train_dataset.img_wh,
        generator=torch.Generator().manual_seed(hparams.seed), device=dev)
    if hparams.ckpt_path:
        state = load_ckpt(hparams.ckpt_path, target=state)
        # the marching tables are derived data: repack them from the
        # boolean grid, so a checkpoint from before a layout change does
        # not march empty space until the next grid update
        state["occ_u8"] = pack_marching_grid(state["occ"], cfg)
        print(f'Loaded checkpoint {hparams.ckpt_path} '
              f'(step {state["step"]})')

    if hparams.val_only:
        logs = validate(hparams, cfg, state, test_dataset, val_dir)
        print('validation:', logs)
        return logs

    big = train_dataset.rays.nbytes > 2 << 30
    scene = train_dataset.scene(images_uint8=big)
    gen = torch.Generator(device=dev).manual_seed(hparams.seed)

    total_steps = cfg.total_steps
    log_dir = hparams.log_dir or (os.path.join(val_dir, 'logs')
                                  if val_dir else None)
    logger = ScalarLogger(log_dir)
    stats = TrainingStats(total_steps, log_interval=100, logger=logger)
    profiler_ctx = None
    prof_start = min(200, total_steps // 2)
    t0 = time.time()
    t_warm, step_warm = None, 0
    rays_done = 0
    for step in range(state["step"], total_steps):
        if hparams.profile_steps and step == prof_start:
            profiler_ctx = profile_trace(os.path.join(
                log_dir or ckpt_dir, 'profile'))
            profiler_ctx.__enter__()
        if profiler_ctx is not None and \
                step == prof_start + hparams.profile_steps:
            profiler_ctx.__exit__(None, None, None)
            profiler_ctx = None
        stats.iter_tic()
        if step % cfg.grid_update_interval == 0:
            grid_update_step(state, cfg, warmup=step < cfg.warmup_steps,
                             generator=gen)
        state, metrics = fused_train_step(state, scene, cfg, generator=gen)
        rays_done += cfg.batch_size
        if (step + 1) % 100 == 0:
            m = {k: float(v) for k, v in metrics.items()}   # reads the card
            stats.iter_toc()
            dt = time.time() - t0
            if t_warm is None:
                t_warm, step_warm = time.time(), step + 1
            stats.update(m)
            stats.log_iter_stats(step + 1,
                                 extra={'rays_per_sec': rays_done / dt})
        else:
            stats.iter_toc()
    if profiler_ctx is not None:
        profiler_ctx.__exit__(None, None, None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_time = time.time() - t0
    # net of warm-up: the first 100 steps absorb the kernel builds and
    # first calls; extrapolate the rate after them
    train_time_net = train_time
    steady = None
    if t_warm is not None and total_steps > step_warm:
        steady = (time.time() - t_warm) / (total_steps - step_warm)
        train_time_net = steady * total_steps
    print(f'Total training time: {train_time:.1f}s '
          f'(net of compile ~{train_time_net:.1f}s)')

    epoch = hparams.num_epochs - 1
    save_ckpt(os.path.join(ckpt_dir, f'epoch={epoch}'), state)
    save_slim_ckpt(os.path.join(ckpt_dir, f'epoch={epoch}_slim'), state,
                   save_poses=hparams.optimize_ext)

    logs = validate(hparams, cfg, state, test_dataset, val_dir)
    logs['train_time_net_s'] = round(float(train_time_net), 1)
    if steady is not None:
        logs['ms_per_step'] = 1e3 * steady
        logs['rays_per_sec'] = cfg.batch_size / steady
    print('test:', logs)
    logger.log(total_steps, {f'test/{k}': v for k, v in logs.items()})
    logger.close()
    if val_dir and hparams.dataset_name == 'nsvf' and \
            'Synthetic' in hparams.root_dir:
        save_videos(val_dir, fps=video_fps)
    return logs


if __name__ == '__main__':
    main(get_opts())
