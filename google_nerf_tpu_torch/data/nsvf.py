"""NSVF-format datasets: Synthetic-NeRF / Synthetic-NSVF / BlendedMVS /
TanksAndTemples (port of google_nerf_tpu/data/nsvf.py).

bbox.txt AABB, the per-scene scale fixes, the 0_/1_/2_ split prefixes,
black-to-white backgrounds for Jade and Fountain, alpha on white, and
the [-0.5, 0.5]^3 pose normalisation, as a per-family table over the
shared parallel loaders.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional, Tuple

import numpy as np

from google_nerf_tpu_torch.data.base import BaseDataset, directions_of
from google_nerf_tpu_torch.data.loaders import (bbox_shift_scale,
                                                load_image_stack,
                                                load_pose_stack,
                                                normalize_c2w)


@dataclasses.dataclass(frozen=True)
class _Family:
    image_wh: Optional[Tuple[int, int]]    # None = read K file directly
    single_focal: bool                     # intrinsics.txt is one number
    test_prefix: str                       # split-file prefix for 'test'


# scene-family dispatch, by substring of the root
_FAMILIES = {
    "Synthetic": _Family((800, 800), True, "2_"),
    "Ignatius": _Family((1920, 1080), True, "1_"),
    "BlendedMVS": _Family((768, 576), False, "1_"),
    "Tanks": _Family((1920, 1080), False, "1_"),
}

# per-scene AABB enlargements
_SCENE_SCALE_FIX = {"Mic": 1.2, "Lego": 1.1}

# scenes whose black background must read as white
_BLACK_TO_WHITE = ("Jade", "Fountain")


def _family_of(root_dir: str) -> _Family:
    for token, fam in _FAMILIES.items():
        if token in root_dir:
            return fam
    raise ValueError(f"cannot infer NSVF scene family for {root_dir}")


class NSVFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0,
                 device="cuda", **kwargs):
        super().__init__(root_dir, split, downsample, device)
        fam = _family_of(root_dir)

        bbox = np.loadtxt(os.path.join(root_dir, "bbox.txt"))[:6]
        self.shift, self.scale = bbox_shift_scale(bbox[:3], bbox[3:6])
        for token, fix in _SCENE_SCALE_FIX.items():
            if token in root_dir and fam.single_focal:
                self.scale *= fix

        if fam.single_focal:
            with open(os.path.join(root_dir, "intrinsics.txt")) as f:
                focal = float(f.readline().split()[0]) * downsample
            w, h = (int(v * downsample) for v in fam.image_wh)
            K = np.float32([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        else:
            K = np.loadtxt(os.path.join(root_dir, "intrinsics.txt"),
                           dtype=np.float32)[:3, :3]
            w, h = (int(v * downsample) for v in fam.image_wh)
            K[:2] *= downsample
        self.K = K.astype(np.float32)
        self.img_wh = (w, h)
        self.directions = directions_of(h, w, self.K)
        self._read_split(split, fam)

    def _read_split(self, split: str, fam: _Family):
        if split == "test_traj":
            self.poses = self._test_trajectory()
            return
        prefix = {"train": "0_", "trainval": "[0-1]_",
                  "test": fam.test_prefix}.get(split)
        if prefix is None:
            raise ValueError(f"{split} split not recognized!")
        img_paths = sorted(glob.glob(
            os.path.join(self.root_dir, "rgb", prefix + "*.png")))
        pose_paths = sorted(glob.glob(
            os.path.join(self.root_dir, "pose", prefix + "*.txt")))
        print(f"Loading {len(img_paths)} {split} images ...")

        fix_bg = any(t in self.root_dir for t in _BLACK_TO_WHITE)

        def white_fix(img):
            return np.where(np.all(img <= 0.1, -1, keepdims=True), 1.0, img)

        self.rays = load_image_stack(img_paths, self.img_wh,
                                     postprocess=white_fix if fix_bg
                                     else None)
        self.poses = normalize_c2w(load_pose_stack(pose_paths),
                                   self.shift, self.scale)

    def _test_trajectory(self) -> np.ndarray:
        """BlendedMVS / T&T fly-through cameras ([left down front] input)."""
        per_file = sorted(glob.glob(
            os.path.join(self.root_dir, "test_pose/*.txt")))
        if per_file:
            traj = load_pose_stack(per_file)
        else:
            traj = np.loadtxt(os.path.join(
                self.root_dir, "test_traj.txt")).reshape(-1, 4, 4)[:, :3]
        traj = np.array(traj, np.float32)
        traj[:, :, 0] *= -1  # ldf -> rdf
        return normalize_c2w(traj, self.shift, self.scale)
