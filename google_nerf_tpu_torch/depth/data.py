"""The multi-dataset loader of depth training (port of
google_nerf_tpu/depth/data.py; the reference's
`Train/data/multi_dataset.py`, annotation-JSON datasets with online
augmentation, and `Train/data/load_dataset_distributed.py:40-287`, the
interleaving multi-dataset sampler).

Host-side numpy: each item is a dict of fixed (crop_h, crop_w) arrays in
JAX's layout (rgb (H, W, 3) normalised, depth, disp and planes (H, W),
focal_length, quality_flg), which the trainer moves to the device.  A
dataset is a list of annotations {rgb_path, depth_path, ...} from
`<root>/<name>/annotations/<split>_annotations[_subset].json`.

Kept from the reference: depth and disparity scaled to a maximum of 10
(`multi_dataset.py:268-271`); invalid values -1 (`:273-276`);
quality_flg 3 for taskonomy and 3d-ken-burns, 2 for diml, 1 otherwise
(`:199-205`); colour jitter, flip, resize (ratio in {0.5 ... 1.2} of the
crop), random crop or pad (`set_flip_resize_crop_pad`, `:314-360`);
ImageNet normalisation (`scale_torch`, `:362-380`); the sampler's
[A, B, C, A, B, C, ...] interleave with per-rank strided shards.

Images are read by the port's own codec (utils/image.read_image: PNG
and JPEG) and resized with cv2's sample positions (resize_linear,
resize_nearest), where JAX uses cv2; the augmentation draws from a
numpy Generator in JAX's order (contrast, saturation, flip, ratio, crop
offsets), so one seed gives JAX's arrays.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from google_nerf_tpu_torch.depth.config import DatasetCfg
from google_nerf_tpu_torch.utils.image import (read_image, resize_linear,
                                               resize_nearest)

_QUALITY = {"taskonomy": 3, "3d-ken-burns": 3, "diml": 2}
_FOCAL = {"taskonomy": 512.0}


def _resize(img: np.ndarray, hw, nearest: bool) -> np.ndarray:
    """(H, W[, C]) -> (hw[0], hw[1][, C]) with cv2.resize's sample
    positions (INTER_NEAREST or INTER_LINEAR), in float32 for linear."""
    fn = resize_nearest if nearest else resize_linear
    return fn(torch.from_numpy(np.ascontiguousarray(img)),
              (hw[1], hw[0])).numpy()


class DepthAnnotationDataset:
    """One source dataset (the reference's `MultiDataset`, one annotation
    file)."""

    def __init__(self, root: str, name: str, split: str = "train",
                 cfg: DatasetCfg = DatasetCfg(),
                 annotations: Optional[List[dict]] = None):
        self.root, self.name, self.split, self.cfg = root, name, split, cfg
        if annotations is None:
            path = None
            adir = os.path.join(root, name, "annotations")
            for suffix in (f"{split}_annotations_subset.json",
                           f"{split}_annotations.json"):
                cand = os.path.join(adir, suffix)
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                raise FileNotFoundError(f"no annotations for {name}/{split}")
            with open(path) as f:
                annotations = json.load(f)
        self.annotations = annotations
        key = next((k for k in _QUALITY if k in name.lower()), None)
        self.quality_flg = _QUALITY.get(key, 1)
        self.focal_length = _FOCAL.get(name.lower(), cfg.focal_x)

    def __len__(self):
        return len(self.annotations)

    def _path(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def _load_raw(self, i: int):
        a = self.annotations[i]
        rgb = read_image(self._path(a["rgb_path"]))
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, -1)
        rgb = rgb[..., :3].astype(np.float32)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
        depth = read_image(self._path(a["depth_path"])).astype(np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        disp = np.where(depth > 1e-8, 1.0 / np.maximum(depth, 1e-8), 0.0)
        return rgb, depth, disp

    def _finalize(self, rgb, depth, disp, planes):
        c = self.cfg
        depth = depth / (depth.max() + 1e-8) * 10.0
        disp = disp / (disp.max() + 1e-8) * 10.0
        invalid = (depth > 1e7) | (depth < 0)
        depth = np.where(invalid, c.invalid_value, depth)
        disp = np.where((disp > 1e7) | (disp < 0), c.invalid_value, disp)
        rgb = (rgb - np.asarray(c.rgb_pixel_means)) \
            / np.asarray(c.rgb_pixel_vars)
        return dict(rgb=rgb.astype(np.float32),
                    depth=depth.astype(np.float32),
                    disp=disp.astype(np.float32),
                    planes=planes.astype(np.int32),
                    focal_length=np.float32(self.focal_length),
                    quality_flg=np.int32(self.quality_flg))

    def get_val(self, i: int) -> Dict[str, np.ndarray]:
        """The deterministic item (`online_aug_val`): resized to the
        crop."""
        rgb, depth, disp = self._load_raw(i)
        ch, cw = self.cfg.crop_size
        rgb = _resize(rgb, (ch, cw), nearest=False)
        depth = _resize(depth, (ch, cw), nearest=True)
        disp = _resize(disp, (ch, cw), nearest=True)
        return self._finalize(rgb, depth, disp,
                              np.zeros((ch, cw), np.int32))

    def get_train(self, i: int, rng: np.random.Generator
                  ) -> Dict[str, np.ndarray]:
        """A randomly augmented item (`online_aug`,
        `multi_dataset.py:212`)."""
        rgb, depth, disp = self._load_raw(i)
        ch, cw = self.cfg.crop_size
        # colour jitter: contrast 0.3, saturation 0.1 (`rgb_aug`, :300-312)
        contrast = 1.0 + rng.uniform(-0.3, 0.3)
        mean = rgb.mean()
        rgb = np.clip((rgb - mean) * contrast + mean, 0, 1)
        gray = rgb.mean(-1, keepdims=True)
        sat = 1.0 + rng.uniform(-0.1, 0.1)
        rgb = np.clip(gray + (rgb - gray) * sat, 0, 1)
        # flip / resize / crop / pad (`set_flip_resize_crop_pad`)
        if rng.random() < 0.5:
            rgb, depth, disp = rgb[:, ::-1], depth[:, ::-1], disp[:, ::-1]
        ratio = rng.choice([0.5, 0.6, 0.8, 1.0, 1.2])
        rh, rw = max(int(ch * ratio), 1), max(int(cw * ratio), 1)
        rh2 = max(rh, int(rh * ch / max(cw, 1)))
        rgb = _resize(rgb, (rh2, rw), nearest=False)
        depth = _resize(depth, (rh2, rw), nearest=True)
        disp = _resize(disp, (rh2, rw), nearest=True)

        def crop_pad(img, fill):
            h, w = img.shape[:2]
            if h >= ch and w >= cw:
                y0 = rng.integers(0, h - ch + 1)
                x0 = rng.integers(0, w - cw + 1)
                return img[y0:y0 + ch, x0:x0 + cw]
            pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
            pads = [(0, pad_h), (0, pad_w)] + [(0, 0)] * (img.ndim - 2)
            return np.pad(img, pads, constant_values=fill)[:ch, :cw]

        # one crop for every modality: crop the stack
        stack = np.concatenate([rgb, depth[..., None], disp[..., None]], -1)
        stack = crop_pad(stack, 0.0)
        rgb, depth, disp = stack[..., :3], stack[..., 3], stack[..., 4]
        return self._finalize(rgb, depth, disp,
                              np.zeros((ch, cw), np.int32))


class MultiDatasetSampler:
    """Interleaves N datasets [A, B, C, A, B, C, ...] with per-rank
    strided shards (`CustomerMultiDataSampler`,
    `load_dataset_distributed.py:40-287`)."""

    def __init__(self, datasets: Sequence[DepthAnnotationDataset],
                 rank: int = 0, world_size: int = 1, seed: int = 0):
        self.datasets = list(datasets)
        self.rank, self.world = rank, world_size
        self.seed = seed
        self.max_len = max(len(d) for d in self.datasets)

    def __len__(self):
        return self.max_len * len(self.datasets) // self.world

    def epoch_indices(self, epoch: int) -> List[tuple]:
        """[(dataset index, item index), ...] of this rank and epoch; each
        dataset is tiled up to the longest, so the interleave is
        balanced."""
        rng = np.random.default_rng(self.seed + epoch)
        per_ds = []
        for d in self.datasets:
            idx = rng.permutation(len(d))
            reps = int(np.ceil(self.max_len / len(d)))
            per_ds.append(np.tile(idx, reps)[:self.max_len])
        order = [(k, int(per_ds[k][i])) for i in range(self.max_len)
                 for k in range(len(self.datasets))]
        return order[self.rank::self.world]

    def batches(self, epoch: int, batch_size: int, train: bool = True):
        """Yield stacked batch dicts (numpy)."""
        rng = np.random.default_rng(self.seed * 7919 + epoch)
        idxs = self.epoch_indices(epoch)
        for i in range(0, len(idxs) - batch_size + 1, batch_size):
            items = []
            for ds_i, it_i in idxs[i:i + batch_size]:
                d = self.datasets[ds_i]
                items.append(d.get_train(it_i, rng) if train
                             else d.get_val(it_i))
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
