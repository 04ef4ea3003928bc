"""Base dataset: length and sampling conventions (port of
google_nerf_tpu/data/base.py).

A training "epoch" is 1000 iterations; a training item is a batch of
`batch_size` random (image, pixel) pairs {rgb, img_idxs, pix_idxs} (and
depth where priors exist); a test item is one image {pose, img_idxs,
rgb}.  The arrays stay numpy on the host; `scene()` puts the whole
dataset on a device as torch tensors (images as uint8 if asked) for the
fused train step, which samples its batches there.
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.core.rays import get_ray_directions


def directions_of(h: int, w: int, K, **kw) -> np.ndarray:
    """(h*w, 3) float32 camera-space directions, computed on the CPU."""
    return get_ray_directions(h, w, K, device="cpu", **kw).numpy()


class BaseDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 downsample: float = 1.0, device="cuda"):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.device = device
        self.batch_size = 8192
        self.rays: np.ndarray = np.zeros((0, 0, 3), np.float32)
        self.poses: np.ndarray = np.zeros((0, 3, 4), np.float32)
        self.depths = None  # optional (N, HW) depth priors

    def __len__(self):
        if self.split.startswith("train"):
            return 1000
        return len(self.poses)

    def sample(self, rng: np.random.Generator, batch_size=None):
        """Host-side random ray batch (numpy)."""
        bs = batch_size or self.batch_size
        img_idxs = rng.integers(0, len(self.poses), bs)
        pix_idxs = rng.integers(0, self.img_wh[0] * self.img_wh[1], bs)
        batch = {"rgb": self.rays[img_idxs, pix_idxs],
                 "img_idxs": img_idxs, "pix_idxs": pix_idxs}
        if self.depths is not None:
            batch["depth"] = self.depths[img_idxs, pix_idxs]
        return batch

    def __getitem__(self, idx):
        if self.split.startswith("train"):
            return self.sample(np.random.default_rng())
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            sample["rgb"] = self.rays[idx]
        return sample

    def scene(self, images_uint8: bool = False):
        """The scene on self.device for the fused train step: images
        (N, HW, 3) (uint8 if asked), poses (N, 3, 4), directions (HW, 3)
        and, with priors, depths (N, HW)."""
        dev = self.device
        imgs = self.rays
        if images_uint8:
            imgs = np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8)
        s = dict(images=torch.as_tensor(imgs, device=dev),
                 poses=torch.as_tensor(self.poses, dtype=torch.float32,
                                       device=dev),
                 directions=torch.as_tensor(self.directions,
                                            dtype=torch.float32, device=dev))
        if self.depths is not None:
            s["depths"] = torch.as_tensor(self.depths, dtype=torch.float32,
                                          device=dev)
        return s
