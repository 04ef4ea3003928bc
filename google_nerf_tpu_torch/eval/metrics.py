"""Image quality metrics: MSE, PSNR, SSIM and LPIPS (port of
google_nerf_tpu/eval/metrics.py).

SSIM has torchmetrics' defaults (gaussian window 11, sigma 1.5, valid
padding, data_range 1).  LPIPS is the VGG16 trunk with linear heads on
weights supplied as an .npz in the JAX layout (conv{i}_w/conv{i}_b OIHW,
lin{j}_w); without weights `LPIPS` reports `available == False` and
scores None, as in JAX.

JAX convolves at Precision.HIGHEST; cuDNN runs float32 convolutions in
TF32 unless told otherwise, so every convolution here runs with TF32
off, scoped to the call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def mse(image_pred, image_gt, valid_mask=None):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    return value.mean()


def psnr(image_pred, image_gt, valid_mask=None):
    return -10.0 * torch.log10(
        torch.clamp_min(mse(image_pred, image_gt, valid_mask), 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device="cpu"):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img, kernel):
    """img: (N, C, H, W); kernel: (k, k) -> depthwise valid convolution."""
    c, k = img.shape[1], kernel.shape[0]
    with torch.backends.cudnn.flags(allow_tf32=False):
        return F.conv2d(img, kernel.expand(c, 1, k, k).contiguous(),
                        groups=c)


def ssim(pred, gt, data_range: float = 1.0):
    """Structural similarity with torchmetrics defaults.

    pred/gt: (H, W, C) or (N, C, H, W); returns the mean SSIM (0-d).  An
    image smaller than the 11x11 window has no valid window: NaN, the
    mean over none, as JAX's valid convolution gives."""
    if pred.ndim == 3:  # HWC -> NCHW
        pred = pred.permute(2, 0, 1)[None]
        gt = gt.permute(2, 0, 1)[None]
    pred = pred.float()
    gt = gt.float()
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    kern = _gaussian_kernel(device=pred.device)
    if min(pred.shape[-2:]) < kern.shape[0]:
        return torch.full((), float("nan"), device=pred.device)
    mu_x = _filter2d(pred, kern)
    mu_y = _filter2d(gt, kern)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _filter2d(pred * pred, kern) - mu_xx
    sig_y = _filter2d(gt * gt, kern) - mu_yy
    sig_xy = _filter2d(pred * gt, kern) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sig_x + sig_y + c2)
    return (num / den).mean()


# VGG16 conv layout; LPIPS taps the activation after each block's last ReLU.
_VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256),
               (512, 512, 512), (512, 512, 512))
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_lpips_weights(path: str, device="cuda"):
    """Load an .npz with conv{i}_w/conv{i}_b (OIHW) and lin{j}_w arrays."""
    with np.load(path) as data:
        return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


def _vgg_features(weights, x):
    """x: (N, 3, H, W) in [-1, 1] -> list of 5 block activations."""
    dev = x.device
    x = (x - torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]) / \
        torch.as_tensor(_SCALE, device=dev)[None, :, None, None]
    feats = []
    li = 0
    for b, widths in enumerate(_VGG_BLOCKS):
        for _ in widths:
            x = F.conv2d(x, weights[f"conv{li}_w"], padding=1)
            x = torch.relu(x + weights[f"conv{li}_b"][None, :, None, None])
            li += 1
        feats.append(x)
        if b < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2)
    return feats


def _lpips_impl(weights, x, y):
    """LPIPS distance of NCHW images x, y in [-1, 1] (0-d tensor)."""
    with torch.backends.cudnn.flags(allow_tf32=False):
        fx = _vgg_features(weights, x)
        fy = _vgg_features(weights, y)
    total = 0.0
    for j, (a, b) in enumerate(zip(fx, fy)):
        a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
        b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
        d = (a - b) ** 2
        total = total + (d * weights[f"lin{j}_w"]).sum(1).mean()
    return total


class LPIPS:
    """LPIPS-vgg scorer.  Images in [0, 1], shape (H, W, 3)."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        self.weights = (load_lpips_weights(weights_path, device)
                        if weights_path else None)

    @property
    def available(self) -> bool:
        return self.weights is not None

    def __call__(self, pred, gt):
        if self.weights is None:
            return None
        x = torch.clamp(pred.permute(2, 0, 1)[None] * 2 - 1, -1, 1)
        y = torch.clamp(gt.permute(2, 0, 1)[None] * 2 - 1, -1, 1)
        return _lpips_impl(self.weights, x, y)
