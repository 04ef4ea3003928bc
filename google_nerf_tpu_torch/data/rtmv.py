"""RTMV dataset: per-frame json camera_data, the 100/5/45 split (port of
google_nerf_tpu/data/rtmv.py), with the bricks-subset rescale into
[-0.5, 0.5]^3.  Frames decode through the port's reader: RTMV's own
OpenEXR frames (HALF or FLOAT RGBA, ZIP-compressed as RTMV ships them,
composited onto white like PNG frames), and PNG and JPEG frames."""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from google_nerf_tpu_torch.data.base import BaseDataset, directions_of
from google_nerf_tpu_torch.data.loaders import (bbox_shift_scale,
                                                load_image_stack,
                                                normalize_c2w)

# split boundaries
_SPLIT_RANGES = {"train": (0, 100), "trainval": (0, 105),
                 "test": (105, 150)}


class RTMVDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0,
                 device="cuda", **kwargs):
        super().__init__(root_dir, split, downsample, device)
        ds = downsample
        with open(os.path.join(root_dir, "00000.json")) as f:
            meta = json.load(f)["camera_data"]
        self.shift, self.scale = bbox_shift_scale(
            np.asarray(meta["scene_min_3d_box"]),
            np.asarray(meta["scene_max_3d_box"]))
        self.shift = np.asarray(meta["scene_center_3d_box"], np.float32)
        intr = meta["intrinsics"]
        self.K = np.float32([[intr["fx"] * ds, 0, intr["cx"] * ds],
                             [0, intr["fy"] * ds, intr["cy"] * ds],
                             [0, 0, 1]])
        w, h = int(meta["width"] * ds), int(meta["height"] * ds)
        self.img_wh = (w, h)
        self.directions = directions_of(h, w, self.K)

        s, e = _SPLIT_RANGES.get(split, (0, 150))
        img_paths = sorted(glob.glob(
            os.path.join(root_dir, "images/*")))[s:e]
        json_paths = sorted(glob.glob(os.path.join(root_dir, "*.json")))[s:e]
        print(f"Loading {len(img_paths)} {split} images ...")

        def read_c2w(path):
            with open(path) as f:
                cam = json.load(f)["camera_data"]
            return np.asarray(cam["cam2world"], np.float32).T[:3]

        poses = np.stack([read_c2w(p) for p in json_paths])
        poses[:, :, 1:3] *= -1                    # OpenGL -> rdf
        if "bricks" in root_dir:                  # the bricks rescale
            poses = normalize_c2w(poses, self.shift, self.scale)
        self.poses = poses.astype(np.float32)
        self.rays = load_image_stack(img_paths, self.img_wh)
