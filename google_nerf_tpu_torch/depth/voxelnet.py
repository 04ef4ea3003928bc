"""The dense 64^3 point-cloud regressor for focal and shift refinement
(port of google_nerf_tpu/depth/voxelnet.py, JAX's dense redesign of the
reference's SPVCNN classifier, `Minist_Test/lib/spvcnn_classsification.py`,
used by `test_utils.refine_focal/refine_shift:112-131`).

The point cloud is rasterised into a fixed G^3 grid of [occupancy, mean
dx, mean dy, mean dz] per voxel (index_add_ where JAX scatter-adds), and
a small dense 3-D CNN (nn.Conv3d, flax's BatchNorm at momentum 0.9:
batch statistics in training, running statistics in eval mode) maps it
to one scalar.  It cannot load the published SPVCNN weights; the sparse
executor in depth/spvcnn.py does.  Weights carry across from flax with
convert.voxelnet_state_from_jax.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from google_nerf_tpu_torch.depth.model import _lecun_normal_
from google_nerf_tpu_torch.utils.precision import exact_f32


def voxelize_points(points: torch.Tensor, valid: torch.Tensor,
                    grid: int = 64) -> torch.Tensor:
    """points: (N, 3) f32; valid: (N,) bool -> (G, G, G, 4) features
    [occupancy, mean dx, mean dy, mean dz] over the cloud's normalised
    cube (JAX's layout, channels last)."""
    pts = torch.where(valid[:, None], points, 0.0)
    n_valid = valid.sum().clamp_min(1)
    center = pts.sum(0) / n_valid
    # the largest |pts - center| of the valid rows, at least 1e-3
    half = torch.where(valid[:, None], (pts - center).abs(),
                       1e-3).max().clamp_min(1e-3)
    x01 = ((points - center) / (2 * half) + 0.5).clamp(0.0, 1.0 - 1e-6)
    ijk = (x01 * grid).to(torch.int32)
    flat = (ijk[:, 0] * grid + ijk[:, 1]) * grid + ijk[:, 2]
    flat = torch.where(valid, flat, grid ** 3).long()  # a spare bin
    ones = valid.float()
    frac = x01 * grid - ijk.float() - 0.5
    cnt = points.new_zeros(grid ** 3 + 1).index_add_(0, flat, ones)
    sums = points.new_zeros((grid ** 3 + 1, 3)).index_add_(
        0, flat, frac * ones[:, None])
    cnt, sums = cnt[:-1], sums[:-1]
    occ = (cnt > 0).float()
    mean = sums / cnt.clamp_min(1)[:, None]
    feat = torch.cat([occ[:, None], mean], -1)
    return feat.reshape(grid, grid, grid, 4)


class BatchNorm3d(nn.BatchNorm3d):
    """nn.BatchNorm3d at eps 1e-5 whose train-mode forward is flax's
    nn.BatchNorm at momentum 0.9 (the biased batch variance, in the
    normalisation and in the running update); eval mode is torch's, on
    the running statistics (as backbones.BatchNorm2d)."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, (0, 2, 3, 4), correction=0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


class VoxelConvBlock(nn.Module):
    """3^3 conv (padding 1, no bias) + BatchNorm + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, 3, stride, padding=1,
                              bias=False)
        self.bn = BatchNorm3d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class VoxelResBlock(nn.Module):
    """VoxelConvBlock + 3^3 conv + BatchNorm, plus the input (through a
    strided 1^3 conv + BatchNorm where the width or stride changes),
    then ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.block = VoxelConvBlock(cin, features, stride)
        self.conv = nn.Conv3d(features, features, 3, padding=1, bias=False)
        self.bn = BatchNorm3d(features)
        self.down = None
        if cin != features or stride != 1:
            self.down = nn.Sequential(
                nn.Conv3d(cin, features, 1, stride, bias=False),
                BatchNorm3d(features))

    def forward(self, x):
        h = self.bn(self.conv(self.block(x)))
        return F.relu(h + (x if self.down is None else self.down(x)))


class VoxelNetRegressor(nn.Module):
    """Stem + 4 residual stages of stride 2 + global average pool + MLP
    -> one scalar (the SPVCNN channel plan 32-32-64-128-256 scaled by
    `cr`), softplus'd when out_positive."""

    def __init__(self, cr: float = 0.5):
        super().__init__()
        cs = [int(cr * c) for c in (32, 32, 64, 128, 256)]
        self.stem = VoxelConvBlock(4, cs[0])
        self.stages = nn.ModuleList(
            VoxelResBlock(a, b, stride=2) for a, b in zip(cs[:-1], cs[1:]))
        self.fc1 = nn.Linear(cs[-1], cs[-1] // 2)
        self.fc2 = nn.Linear(cs[-1] // 2, 1)

    def forward(self, vox, out_positive: bool = True):
        """vox: (G, G, G, 4) or (B, G, G, G, 4), channels last as
        voxelize_points gives it -> (B, 1)."""
        x = vox[None] if vox.ndim == 4 else vox
        x = self.stem(x.permute(0, 4, 1, 2, 3))
        for st in self.stages:
            x = st(x)
        x = F.relu(self.fc1(x.mean((2, 3, 4))))
        x = self.fc2(x)
        return F.softplus(x) if out_positive else x


@torch.no_grad()
def init_voxelnet(generator: torch.Generator, cr: float = 0.5,
                  device="cuda") -> VoxelNetRegressor:
    """A VoxelNetRegressor in eval mode with flax's initialisation
    (lecun-normal kernels drawn from `generator`, zero biases, BatchNorm
    at identity), moved to `device`."""
    model = VoxelNetRegressor(cr).to(generator.device)
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
    return model.to(device).eval()


def depth_to_pcd(depth: np.ndarray, focal: float):
    """(H, W) depth -> ((H*W, 3) points, (H*W,) valid) for the refiners
    (`test_utils.depth_to_pcd`: invalid where depth <= 1e-8)."""
    h, w = depth.shape
    u = np.arange(w) - w / 2.0
    v = np.arange(h) - h / 2.0
    x = depth * u[None, :] / focal
    y = depth * v[:, None] / focal
    pts = np.stack([x, y, depth], -1).reshape(-1, 3)
    return pts, (depth > 1e-8).reshape(-1)


def _apply(model, depth, focal, out_positive):
    dev = next(model.parameters()).device
    pts, valid = depth_to_pcd(depth, focal)
    vox = voxelize_points(torch.as_tensor(pts, dtype=torch.float32,
                                          device=dev),
                          torch.as_tensor(valid, device=dev))
    with torch.no_grad(), exact_f32():
        return float(model(vox, out_positive)[0, 0])


def refine_shift(depth_wshift: np.ndarray, model: VoxelNetRegressor,
                 focal: float, max_shift: float = 0.7,
                 steps: int = 1) -> float:
    """Iterative shift recovery (`test_utils.refine_shift:121-131`): the
    head unsquashed, each step's shift clamped at max_shift and taken off
    the depth; returns the total shift."""
    d = np.array(depth_wshift)
    total = 0.0
    for _ in range(steps):
        shift = min(_apply(model, d, focal, False), max_shift)
        d = d - shift
        total += shift
    return total


def refine_focal(depth: np.ndarray, model: VoxelNetRegressor, focal: float,
                 steps: int = 1) -> float:
    """Iterative focal-scale recovery (`test_utils.refine_focal:112-119`).
    Returns the cumulative scale; refined focal = focal / scale."""
    f, scale_total = float(focal), 1.0
    for _ in range(steps):
        scale = _apply(model, depth, f, True)
        f = f / max(scale, 1e-3)
        scale_total *= scale
    return scale_total
