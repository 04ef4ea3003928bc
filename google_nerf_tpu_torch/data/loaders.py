"""Shared loader machinery of the dataset classes (port of
google_nerf_tpu/data/loaders.py).

  * load_image_stack: thread-pooled decode of every frame into one
    (N, H*W, 3) float32 block (the images of the device-resident scene);
  * normalize_c2w: the [-0.5, 0.5]^3 pose renormalisation the loaders
    apply (translation -= shift; /= 2*scale).

Frames decode through the port's own reader (utils/image.py: PNG and
baseline JPEG) and resize with cv2.resize's INTER_LINEAR sample
positions; the C decoder releases the GIL, so the threads overlap.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from google_nerf_tpu_torch.utils.image import (read_image, resize_linear,
                                               resize_nearest)


def srgb_to_linear(img):
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4,
                    img / 12.92)


def linear_to_srgb(img):
    limit = 0.0031308
    out = np.where(img > limit, 1.055 * img ** (1 / 2.4) - 0.055,
                   12.92 * img)
    return np.minimum(out, 1.0)


def resize_to(img: np.ndarray, img_wh, nearest: bool = False) -> np.ndarray:
    """cv2.resize(img, img_wh) (INTER_LINEAR, or INTER_NEAREST) on a
    float32 (H, W[, C]) array."""
    fn = resize_nearest if nearest else resize_linear
    return fn(torch.from_numpy(np.ascontiguousarray(img)), img_wh).numpy()


def decode_image(path: str, img_wh, alpha_bg: Optional[float] = 1.0
                 ) -> np.ndarray:
    """One frame -> (h*w, 3) float32 in [0, 1].

    alpha_bg: compose RGBA onto this constant background (1.0 = white as in
    synthetic scenes, 0.0 = black); None keeps premultiplied RGB only."""
    img = np.asarray(read_image(path), np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if img.shape[-1] == 4:
        rgb, a = img[..., :3], img[..., 3:]
        img = rgb * a + (0.0 if alpha_bg is None else alpha_bg) * (1 - a)
    if tuple(img.shape[1::-1]) != tuple(img_wh):
        img = resize_to(img, img_wh)
    return img.reshape(-1, 3)


def load_image_stack(paths: Sequence[str], img_wh, *,
                     alpha_bg: Optional[float] = 1.0,
                     postprocess: Optional[Callable] = None,
                     workers: int = 16) -> np.ndarray:
    """All frames -> (N, H*W, 3) float32, decoded in parallel."""
    out = np.empty((len(paths), img_wh[0] * img_wh[1], 3), np.float32)

    def job(i):
        img = decode_image(paths[i], img_wh, alpha_bg)
        out[i] = postprocess(img) if postprocess else img

    with ThreadPoolExecutor(max_workers=min(workers, max(len(paths), 1))
                            ) as pool:
        list(pool.map(job, range(len(paths))))
    return out


def load_pose_stack(paths: Sequence[str], reader=None) -> np.ndarray:
    """Pose txt files -> (N, 3, 4) float32 c2w."""
    reader = reader or (lambda p: np.loadtxt(p).reshape(-1, 4)[:3])
    return np.stack([np.asarray(reader(p), np.float32) for p in paths])


def normalize_c2w(poses: np.ndarray, shift, scale) -> np.ndarray:
    """Map scene bounds into [-0.5, 0.5]^3: t = (t - shift) / (2*scale)."""
    out = np.array(poses, np.float32)
    out[..., 3] = (out[..., 3] - np.asarray(shift, np.float32)) / (2 * scale)
    return out


def bbox_shift_scale(xyz_min, xyz_max, enlarge: float = 1.05):
    """AABB -> (center shift, half-extent scale * enlarge)."""
    xyz_min = np.asarray(xyz_min, np.float32)
    xyz_max = np.asarray(xyz_max, np.float32)
    return (xyz_max + xyz_min) / 2, float((xyz_max - xyz_min).max() / 2
                                          * enlarge)
