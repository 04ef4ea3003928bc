"""ScanNet depth-prior dumper CLI of the PyTorch port (the port's
depth_eval_scannet.py; the reference's
`Train/tools/eval_scannet.py:335-467`).

For every frame of a processed ScanNet scene's rgb/ directory, run the
(cIMLE) depth model with --num_samples latent hypotheses in minibatches
of 5 (one depth shift per minibatch) and write

  <out>/<frame>.npy                the prior of hypothesis 0 (what
                                   ScannetDataset(depth_dir=...) reads)
  <out>/<frame>-sample<k>.npy      the other hypotheses (--all_samples)
  <out>/<frame>-depth_rainbow.png  (--save_rainbow)
  <out>/<frame>-pcd.ply            (--save_ply; f = 577.870605 as
                                   `eval_scannet.py:405-406`)

and, where depth/<frame>.png (16 bits, mm) exists, the reference's
metric battery (absRel, silog, delta1, WHDR, ...) averaged over frames.
cIMLE is on whenever --d_latent > 0 (the default), even with one
hypothesis.  Latents are drawn from a torch.Generator seeded by --seed,
one (m, d_latent) draw per (frame, minibatch), on the CPU.

    python depth_eval_scannet_torch.py --scene_dir scans/scene0000_00 \\
        --out_dir priors/scene0000_00 --load_ckpt cimle.npz

Runs on the CUDA card unless given --platform cpu.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from depth_test_torch import BACKBONES, build_model, device_of, read_rgb01
from google_nerf_tpu_torch.depth.metrics import evaluate_rel_err
from google_nerf_tpu_torch.depth.model import DepthModelConfig
from google_nerf_tpu_torch.depth.pointcloud import reconstruct_depth
from google_nerf_tpu_torch.depth.priors import MINIBATCH, frame_priors
from google_nerf_tpu_torch.utils.image import (colorize_rainbow, read_image,
                                               resize_nearest, write_png)

SCANNET_FOCAL = 577.870605  # eval_scannet.py:405-406


def get_args(argv=None):
    p = argparse.ArgumentParser(description="dump ScanNet depth priors "
                                "(PyTorch port)")
    p.add_argument("--scene_dir", required=True,
                   help="processed scene dir with rgb/ (+optional depth/)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--backbone", default="resnext101",
                   choices=list(BACKBONES))
    p.add_argument("--load_ckpt", default=None)
    p.add_argument("--d_latent", type=int, default=32)
    p.add_argument("--num_samples", type=int, default=1,
                   help="cIMLE hypotheses per frame (0/1 = plain model)")
    p.add_argument("--all_samples", action="store_true",
                   help="save every hypothesis, not just the first")
    p.add_argument("--crop_size", type=int, default=448)
    p.add_argument("--save_ply", action="store_true")
    p.add_argument("--save_rainbow", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
    return p.parse_args(argv)


def main(argv=None, latents=None):
    """Run the CLI; returns dict(frames, metrics (the mean battery, or
    {}), frame_s (each frame's wall seconds), build_s, load_s).

    latents: optional latents(frame_index, start, m) -> (m, d_latent)
    array, used in place of the generator's draws (a test passes JAX's)."""
    args = get_args(argv)
    device = device_of(args.platform)
    cimle = args.num_samples > 1 or args.d_latent > 0
    cfg = DepthModelConfig(backbone=BACKBONES[args.backbone],
                           d_latent=args.d_latent if cimle else 0)
    t0 = time.time()
    model = build_model(cfg, None, device)
    build_s = time.time() - t0
    t0 = time.time()
    if args.load_ckpt:
        from google_nerf_tpu_torch.depth.weights import load_checkpoint
        print(load_checkpoint(model, args.load_ckpt))
    load_s = time.time() - t0

    rgb_dir = os.path.join(args.scene_dir, "rgb")
    depth_dir = os.path.join(args.scene_dir, "depth")
    os.makedirs(args.out_dir, exist_ok=True)
    frames = [os.path.splitext(f)[0] for f in sorted(os.listdir(rgb_dir))
              if f.lower().endswith((".jpg", ".png"))]
    print(f"{len(frames)} frames; num_samples={args.num_samples}")

    gen = torch.Generator().manual_seed(args.seed)
    n_z = max(args.num_samples, 1)
    metrics_accum, frame_s = [], []
    for fi, frame in enumerate(frames):
        t0 = time.time()
        path = None
        for ext in (".jpg", ".png"):
            cand = os.path.join(rgb_dir, frame + ext)
            if os.path.exists(cand):
                path = cand
        rgb = read_rgb01(path)
        h, w = rgb.shape[:2]
        z = None
        if cfg.d_latent:
            draws = []
            for start in range(0, n_z, MINIBATCH):
                m = min(MINIBATCH, n_z - start)
                draws.append(np.asarray(
                    latents(fi, start, m) if latents is not None
                    else torch.randn((m, cfg.d_latent), generator=gen),
                    np.float32))
            z = torch.from_numpy(np.concatenate(draws)).to(device)
        preds = frame_priors(model, torch.from_numpy(rgb).to(device), z,
                             args.crop_size, (h, w), n_z=n_z)

        for k in range(n_z if args.all_samples else 1):
            d = preds[k].cpu().numpy()
            suffix = "" if k == 0 else f"-sample{k}"
            np.save(os.path.join(args.out_dir, frame + suffix + ".npy"), d)
            if k == 0:
                d0 = d
        if args.save_rainbow:
            write_png(os.path.join(args.out_dir,
                                   frame + "-depth_rainbow.png"),
                      colorize_rainbow(d0))
        if args.save_ply:
            reconstruct_depth(d0, (rgb * 255).astype(np.uint8),
                              args.out_dir, frame + "-pcd", SCANNET_FOCAL)
        gt_path = os.path.join(depth_dir, frame + ".png")
        if os.path.isdir(depth_dir) and os.path.exists(gt_path):
            gt = read_image(gt_path).astype(np.float32) / 1000.0
            if gt.shape != d0.shape:
                gt = resize_nearest(torch.from_numpy(gt), (w, h)).numpy()
            m = evaluate_rel_err(d0, gt)
            if m:
                metrics_accum.append(m)
        frame_s.append(time.time() - t0)
        if fi % 50 == 0:
            print(f"  frame {fi}/{len(frames)}")
    agg = {}
    if metrics_accum:
        agg = {k: float(np.mean([m[k] for m in metrics_accum]))
               for k in metrics_accum[0]}
        print("metrics:", {k: round(v, 4) for k, v in agg.items()})
    return dict(frames=len(frames), metrics=agg, frame_s=frame_s,
                build_s=build_s, load_s=load_s)


if __name__ == "__main__":
    main(sys.argv[1:])
