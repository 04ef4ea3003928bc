"""Depth-model benchmark evaluation CLI of the PyTorch port (the port's
depth_eval.py; the reference's `Train/tools/test_multiauxiv2_nyu.py`,
`eval_single*.py`, `eval_sorted*.py`): a (cIMLE) depth model on an
annotation-JSON dataset with the metric battery (absRel, squaRel, rms,
silog, log10, delta1-3, WHDR), with --num_samples hypotheses an image
picked by --select: the first, the least ILNR loss against the ground
truth (the eval_*_losssorted variants) or the best absRel (an oracle).

    python depth_eval_torch.py --dataroot datasets --dataset nyu \\
        --load_ckpt final.npz --d_latent 32 --num_samples 10 --select loss

Latents are drawn from a torch.Generator seeded by --seed, one (1,
d_latent) draw per (image, hypothesis), on the CPU.  Runs on the CUDA
card unless given --platform cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from depth_test_torch import build_model, device_of
from depth_train_torch import BACKBONES
from google_nerf_tpu_torch.depth.config import DepthCfg
from google_nerf_tpu_torch.depth.data import DepthAnnotationDataset
from google_nerf_tpu_torch.depth.losses import LossConfig, depth_losses
from google_nerf_tpu_torch.depth.metrics import evaluate_rel_err
from google_nerf_tpu_torch.depth.model import DepthModelConfig, depth_forward

def get_args(argv=None):
    p = argparse.ArgumentParser(description="LeReS depth evaluation "
                                "(PyTorch port)")
    p.add_argument("--dataroot", default="datasets")
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--backbone", default="resnext101",
                   choices=list(BACKBONES))
    p.add_argument("--load_ckpt", default=None)
    p.add_argument("--d_latent", type=int, default=0)
    p.add_argument("--num_samples", type=int, default=1,
                   help=">1 = cIMLE multi-hypothesis")
    p.add_argument("--select", choices=["first", "loss", "best_metric"],
                   default="first",
                   help="hypothesis selection: first z, argmin train loss "
                        "(eval_*_losssorted), or oracle-best absRel")
    p.add_argument("--crop_size", type=int, default=448)
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
    return p.parse_args(argv)


def main(argv=None, latents=None):
    """Run the CLI; returns dict(metrics (the mean battery, unrounded),
    images, image_s (each image's wall seconds)).  latents(i, k) ->
    (1, d_latent) stands in for the generator's draws (a test passes
    JAX's)."""
    args = get_args(argv)
    device = device_of(args.platform)
    dcfg = dataclasses.replace(DepthCfg().dataset,
                               crop_size=(args.crop_size, args.crop_size))
    ds = DepthAnnotationDataset(args.dataroot, args.dataset,
                                split=args.split, cfg=dcfg)
    mcfg = DepthModelConfig(backbone=BACKBONES[args.backbone],
                            d_latent=args.d_latent)
    model = build_model(mcfg, args.load_ckpt, device)
    lcfg = LossConfig(loss_mode="_meanstd-tanh_")
    gen = torch.Generator().manual_seed(args.seed)
    n_imgs = min(len(ds), args.max_images) if args.max_images else len(ds)
    n_z = max(args.num_samples, 1)
    all_metrics, image_s = [], []
    for i in range(n_imgs):
        t0 = time.time()
        item = ds.get_val(i)
        rgb = torch.from_numpy(item["rgb"]).permute(2, 0, 1)[None]
        rgb = rgb.contiguous().to(device)
        gt = item["depth"]
        preds = []
        for k in range(n_z):
            z = None
            if args.d_latent:
                z = (torch.tensor(np.asarray(latents(i, k), np.float32))
                     if latents is not None else
                     torch.randn((1, args.d_latent), generator=gen))
                z = z.to(device)
            preds.append(depth_forward(model, rgb, z)[0, 0])
        if args.select == "first" or n_z == 1:
            best = preds[0]
        elif args.select == "loss":
            data = {"depth": torch.from_numpy(gt)[None].to(device),
                    "rgb": rgb}
            losses = [float(depth_losses(p[None], data, lcfg)["total_raw"][0])
                      for p in preds]
            best = preds[int(np.argmin(losses))]
        else:                                   # the oracle: best absRel
            errs = [evaluate_rel_err(p.cpu().numpy(), gt).get("err_absRel",
                                                              np.inf)
                    for p in preds]
            best = preds[int(np.argmin(errs))]
        m = evaluate_rel_err(best.cpu().numpy(), gt)
        if m:
            all_metrics.append(m)
        image_s.append(time.time() - t0)
        if i % 20 == 0:
            print(f"image {i}/{n_imgs}")
    agg = ({k: float(np.mean([m[k] for m in all_metrics]))
            for k in all_metrics[0]} if all_metrics else {})
    print("metrics:", {k: round(v, 4) for k, v in agg.items()})
    return dict(metrics=agg, images=n_imgs, image_s=image_s)


if __name__ == "__main__":
    main(sys.argv[1:])
