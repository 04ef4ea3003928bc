"""Single-image depth inference CLI of the PyTorch port (the port's
depth_test.py; the reference's `Minist_Test/tools/test_depth.py:40-78`).

For each image in --img_dir: resize to --crop_size square (cv2's
bilinear sample positions), ImageNet-normalise, run the LeReS model
(depth - min + 0.01), resize back, and write <name>-depth_rainbow.png
(matplotlib's rainbow map) and <name>-depth.png (16 bits, x 60000/max);
--save_ply adds <name>-pcd.ply.

    python depth_test_torch.py --img_dir imgs --load_ckpt res101.pth

--load_ckpt takes a reference torch .pth or JAX's .npz
(depth_train.py's); without one the weights are random from seed 0.
Runs on the CUDA card unless given --platform cpu.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                               depth_inference,
                                               init_depth_model)
from google_nerf_tpu_torch.depth.pointcloud import reconstruct_depth
from google_nerf_tpu_torch.depth.weights import load_checkpoint
from google_nerf_tpu_torch.utils.image import (colorize_rainbow, read_image,
                                               resize_linear, write_png)

BACKBONES = {"resnet50": "resnet50", "resnext101": "resnext101_32x8d"}
IMAGE_EXTS = (".jpg", ".png", ".jpeg")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="LeReS depth inference "
                                "(PyTorch port)")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out_dir", default="outputs_depth")
    p.add_argument("--backbone", default="resnext101",
                   choices=list(BACKBONES))
    p.add_argument("--load_ckpt", default=None,
                   help=".pth (torch) or .npz (JAX save_pytree) checkpoint")
    p.add_argument("--crop_size", type=int, default=448)
    p.add_argument("--save_ply", action="store_true",
                   help="also reconstruct point clouds (test_shape.py path)")
    p.add_argument("--focal", type=float, default=1386.0,
                   help="focal length for --save_ply reconstruction")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
    return p.parse_args(argv)


def device_of(platform: str) -> torch.device:
    """--platform cpu runs on the CPU; otherwise the CUDA card, which
    must be there."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --platform cpu to run on the "
                           "CPU")
    return torch.device("cuda")


def build_model(cfg: DepthModelConfig, load_ckpt, device):
    """init_depth_model from seed 0, then --load_ckpt over it."""
    model = init_depth_model(torch.Generator().manual_seed(0), cfg, device)
    if load_ckpt:
        print(load_checkpoint(model, load_ckpt))
    return model


def read_rgb01(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) float32 RGB in [0, 1], as cv2.imread's
    colour read gives it (gray replicated, alpha dropped, 16 bits cut to
    their high byte)."""
    img = read_image(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img[..., :3].astype(np.float32) / 255.0


def infer(model, rgb: np.ndarray, crop: int, device, z=None, n: int = 1):
    """(H, W, 3) [0, 1] -> (n, crop, crop) depth (device tensor): the
    image resized to crop x crop and repeated n times (one shift over the
    batch)."""
    img = torch.from_numpy(rgb).to(device)
    inp = resize_linear(img, (crop, crop)).permute(2, 0, 1)[None]
    return depth_inference(model, inp.expand(n, -1, -1, -1).contiguous(),
                           z)[:, 0]


def main(argv=None):
    args = get_args(argv)
    device = device_of(args.platform)
    cfg = DepthModelConfig(backbone=BACKBONES[args.backbone])
    model = build_model(cfg, args.load_ckpt, device)
    os.makedirs(args.out_dir, exist_ok=True)

    names = [f for f in sorted(os.listdir(args.img_dir))
             if f.lower().endswith(IMAGE_EXTS)]
    print(f"{len(names)} images")
    for name in names:
        rgb = read_rgb01(os.path.join(args.img_dir, name))
        h, w = rgb.shape[:2]
        pred = infer(model, rgb, args.crop_size, device)[0]
        depth = resize_linear(pred, (w, h)).cpu().numpy()
        base = os.path.splitext(name)[0]
        write_png(os.path.join(args.out_dir, base + "-depth_rainbow.png"),
                  colorize_rainbow(depth))
        d16 = (depth / max(depth.max(), 1e-8) * 60000).astype(np.uint16)
        write_png(os.path.join(args.out_dir, base + "-depth.png"), d16)
        if args.save_ply:
            reconstruct_depth(depth, (rgb * 255).astype(np.uint8),
                              args.out_dir, base + "-pcd", args.focal)
        print(f"  {name}: depth range [{depth.min():.3f}, "
              f"{depth.max():.3f}]")


if __name__ == "__main__":
    main(sys.argv[1:])
