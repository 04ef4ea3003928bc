"""Image quality metrics (port of psnr in google_nerf_tpu/eval/metrics.py;
ssim and lpips come with ROADMAP item 9)."""
from __future__ import annotations

import torch


def mse(image_pred, image_gt, valid_mask=None):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    return value.mean()


def psnr(image_pred, image_gt, valid_mask=None):
    return -10.0 * torch.log10(
        torch.clamp_min(mse(image_pred, image_gt, valid_mask), 1e-12))
