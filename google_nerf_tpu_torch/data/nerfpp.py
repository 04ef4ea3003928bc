"""NeRF++-layout dataset: per-split rgb/, pose/ and intrinsics/ folders
(port of google_nerf_tpu/data/nerfpp.py).  The image size comes from the
first training frame's header, read by the port's own decoder."""
from __future__ import annotations

import glob
import os

import numpy as np

from google_nerf_tpu_torch.data.base import BaseDataset, directions_of
from google_nerf_tpu_torch.data.loaders import (load_image_stack,
                                                load_pose_stack)
from google_nerf_tpu_torch.utils.image import image_size


def _split_dirs(split: str):
    return {"trainval": ("train", "val")}.get(split, (split,))


class NeRFPPDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0,
                 device="cuda", **kwargs):
        super().__init__(root_dir, split, downsample, device)
        ds = downsample
        K = np.loadtxt(glob.glob(
            os.path.join(root_dir, "train/intrinsics/*.txt"))[0],
            dtype=np.float32).reshape(4, 4)[:3, :3]
        K[:2] *= ds
        w, h = (int(v * ds) for v in image_size(glob.glob(
            os.path.join(root_dir, "train/rgb/*"))[0]))
        self.K = K
        self.img_wh = (w, h)
        self.directions = directions_of(h, w, K)

        if split == "test_traj":  # fly-through cameras, no images
            pose_paths = sorted(glob.glob(
                os.path.join(root_dir, "camera_path/pose/*.txt")))
            self.poses = load_pose_stack(pose_paths)
            return

        img_paths, pose_paths = [], []
        for d in _split_dirs(split):
            img_paths += sorted(glob.glob(
                os.path.join(root_dir, d, "rgb/*")))
            pose_paths += sorted(glob.glob(
                os.path.join(root_dir, d, "pose/*.txt")))
        print(f"Loading {len(img_paths)} {split} images ...")
        self.rays = load_image_stack(img_paths, self.img_wh)
        self.poses = load_pose_stack(pose_paths)
