"""Single-image 3-D shape recovery CLI of the PyTorch port (the port's
depth_shape.py; the reference's `Minist_Test/tools/test_shape.py:59-157`).

For each image in --img_dir: run the LeReS depth net at --crop_size
(cv2's bilinear sample positions), resize the depth back, normalise it
(- min + 0.5, / its 98th percentile), then the reference's three-step
refinement on the SPVCNN heads: focal (5 channels) -> shift (3
channels, clamped at 0.6) -> focal again.  Writes
<name>-depth_shifted.png (16 bits, x 60000/max) and <name>-pcd.ply (the
point cloud at the recovered focal length).

    python depth_shape_torch.py --img_dir imgs --load_ckpt res101.pth

--load_ckpt takes the reference's bundled .pth (keys `depth_model`,
`shift_model`, `focal_model`, `net_tools.load_ckpt:27-41`), read with
weights_only: the depth weights load by name, the SPVCNN heads through
depth/spvcnn.convert_spvcnn_state_dict.  What the file lacks keeps its
random init, from seeds 0 (depth), 1 (shift head) and 2 (focal head).
Runs on the CUDA card unless given --platform cpu.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from depth_test_torch import (BACKBONES, IMAGE_EXTS, device_of, infer,
                              read_rgb01)
from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                               init_depth_model)
from google_nerf_tpu_torch.depth.pointcloud import reconstruct_depth
from google_nerf_tpu_torch.depth.spvcnn import (convert_spvcnn_state_dict,
                                                init_spvcnn,
                                                refine_focal_spvcnn,
                                                refine_shift_spvcnn)
from google_nerf_tpu_torch.depth.weights import (load_reference_state,
                                                 strip_prefix)
from google_nerf_tpu_torch.utils.image import resize_linear, write_png


def get_args(argv=None):
    p = argparse.ArgumentParser(description="LeReS shape recovery "
                                "(PyTorch port)")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out_dir", default="outputs_shape")
    p.add_argument("--backbone", default="resnext101",
                   choices=list(BACKBONES))
    p.add_argument("--load_ckpt", default=None,
                   help="the reference's bundled .pth (depth_model, "
                   "shift_model, focal_model)")
    p.add_argument("--crop_size", type=int, default=448)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
    return p.parse_args(argv)


def reconstruct3d_from_depth(rgb, pred_depth, shift_params, focal_params):
    """`test_shape.reconstruct3D_from_depth:59-85`: the depth normalised,
    then focal, shift (clamped at 0.6) and focal again.  Returns (shift,
    focal, the shifted depth)."""
    u0 = rgb.shape[1] / 2.0
    v0 = rgb.shape[0] / 2.0
    dn = pred_depth - pred_depth.min() + 0.5
    dn = dn / np.percentile(dn, 98)
    focal = rgb.shape[0] // 2 / np.tan((60 / 2.0) * np.pi / 180)

    s1 = refine_focal_spvcnn(dn, focal_params, focal, u0, v0)
    focal = focal / max(s1, 1e-3)
    shift = refine_shift_spvcnn(dn, shift_params, focal, u0, v0)
    shift = min(shift, 0.6)
    d_shifted = dn - shift
    s2 = refine_focal_spvcnn(d_shifted, focal_params, focal, u0, v0)
    focal = focal / max(s2, 1e-3)
    return shift, focal, d_shifted


def build_models(cfg: DepthModelConfig, load_ckpt, device):
    """The depth net and the shift (3-channel) and focal (5-channel)
    heads from seeds 0, 1 and 2, then what --load_ckpt holds over them."""
    model = init_depth_model(torch.Generator().manual_seed(0), cfg, device)
    shift_params = init_spvcnn(torch.Generator().manual_seed(1),
                               input_channel=3, device=device)
    focal_params = init_spvcnn(torch.Generator().manual_seed(2),
                               input_channel=5, device=device)
    if load_ckpt:
        raw = torch.load(load_ckpt, map_location="cpu", weights_only=True)
        if "depth_model" in raw:
            skipped, unused = load_reference_state(model, raw["depth_model"])
            print(f"depth_model loaded ({len(skipped)} keys skipped, "
                  f"{len(unused)} not in the model)")

        def head(key):
            return convert_spvcnn_state_dict(
                {strip_prefix(k): v for k, v in raw[key].items()},
                device=device)

        if "shift_model" in raw:
            shift_params = head("shift_model")
        if "focal_model" in raw:
            focal_params = head("focal_model")
    return model, shift_params, focal_params


def main(argv=None):
    args = get_args(argv)
    device = device_of(args.platform)
    cfg = DepthModelConfig(backbone=BACKBONES[args.backbone])
    model, shift_params, focal_params = build_models(cfg, args.load_ckpt,
                                                     device)
    os.makedirs(args.out_dir, exist_ok=True)
    names = [f for f in sorted(os.listdir(args.img_dir))
             if f.lower().endswith(IMAGE_EXTS)]
    for name in names:
        print(f"processing {name}")
        rgb01 = read_rgb01(os.path.join(args.img_dir, name))
        h, w = rgb01.shape[:2]
        pred = infer(model, rgb01, args.crop_size, device)[0]
        depth = resize_linear(pred, (w, h)).cpu().numpy()
        rgb = (rgb01 * 255).astype(np.uint8)
        shift, focal, d_shifted = reconstruct3d_from_depth(
            rgb, depth, shift_params, focal_params)
        base = os.path.splitext(name)[0]
        d16 = (np.maximum(d_shifted, 0.0)
               / max(d_shifted.max(), 1e-8) * 60000.0)
        write_png(os.path.join(args.out_dir, base + "-depth_shifted.png"),
                  d16.astype(np.uint16))
        reconstruct_depth(d_shifted, rgb, args.out_dir, base + "-pcd",
                          focal=focal)
        print(f"  shift={shift:.4f} focal={focal:.1f}")


if __name__ == "__main__":
    main(sys.argv[1:])
