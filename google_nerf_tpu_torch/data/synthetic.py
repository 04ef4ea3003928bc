"""Procedural synthetic scene with analytic ground truth (port of
google_nerf_tpu/data/synthetic.py).

Ground-truth images come from a dense 512-step integration of the
analytic field.  Finished renders are cached as float32 npz files under
the port's own cache directory (GNT_TORCH_GT_CACHE, default
`build/gt_cache` in the checkout); the JAX package's cache is never read.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from google_nerf_tpu_torch.core.rays import get_ray_directions, get_rays
from google_nerf_tpu_torch.ops.composite import composite_rays_train
from google_nerf_tpu_torch.ops.ray_aabb import clamp_near, ray_aabb_intersect

_SPHERES = (
    ((0.16, 0.02, 0.03), 0.17, (0.90, 0.20, 0.20)),
    ((-0.20, 0.10, 0.05), 0.14, (0.20, 0.50, 0.90)),
    ((0.00, -0.17, -0.12), 0.11, (0.95, 0.80, 0.20)),
)
_BOX = ((0.0, 0.20, 0.12), (0.20, 0.05, 0.14), (0.30, 0.85, 0.40))
_SIGMA_MAX = 80.0
_EDGE = 0.005
_SHELL = 0.035
_GT_CACHE = Path(__file__).resolve().parents[2] / "build" / "gt_cache"


def analytic_field(xyz: torch.Tensor, style: str = "solid"):
    """xyz: (..., 3) -> (sigma (...,), rgb (..., 3)); styles "solid",
    "shell" (hollow surfaces) and "textured" (shells with surface
    displacement and a fine 3-D checker albedo)."""
    shelled = style in ("shell", "textured")
    t = lambda v: torch.tensor(v, dtype=xyz.dtype, device=xyz.device)  # noqa
    if style == "textured":
        k1, k2 = 41.0, 19.0
        bump = (torch.sin(k1 * xyz[..., 0]) * torch.sin(k1 * xyz[..., 1])
                * torch.sin(k1 * xyz[..., 2])
                + 0.5 * torch.sin(k2 * (xyz[..., 0] + 1.7 * xyz[..., 1]
                                        - 0.6 * xyz[..., 2]))) / 1.5
        disp = 0.012 * bump
    else:
        disp = 0.0
    sigs, cols = [], []
    for (c, r, col) in _SPHERES:
        d = torch.linalg.norm(xyz - t(c), dim=-1) + disp
        inside = torch.sigmoid((r - d) / _EDGE)
        if shelled:
            inside = inside * torch.sigmoid((d - (r - _SHELL)) / _EDGE)
        sigs.append(inside)
        cols.append(t(col))
    bc, bh, bcol = (t(v) for v in _BOX)
    db = torch.amax(torch.abs(xyz - bc) - bh, dim=-1) + disp
    inside = torch.sigmoid(-db / _EDGE)
    if shelled:
        inside = inside * torch.sigmoid((db + _SHELL) / _EDGE)
    sigs.append(inside)
    cols.append(bcol)
    s = torch.stack(sigs, -1)                                 # (..., n_obj)
    sigma = _SIGMA_MAX * torch.amax(s, -1)
    w = s / torch.clamp_min(s.sum(-1, keepdim=True), 1e-8)
    rgb = w @ torch.stack(cols)
    if style == "textured":
        parity = torch.remainder(torch.floor((xyz + 1.0) * 14.0).sum(-1),
                                 2.0)
        rgb = rgb * (0.45 + 0.4 * parity[..., None]) \
            + (1.0 - rgb) * 0.15 * (1.0 - parity[..., None])
        rgb = torch.clamp(rgb * (0.9 + 0.25 * bump[..., None]), 0.0, 1.0)
    return sigma, rgb


def _look_at_rdf(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w (3, 4) for the [right down front] camera convention."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    world_up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, world_up)) > 0.98:
        world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, world_up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], 1).astype(np.float32)


def _fibonacci_poses(n: int, radius: float, seed: int = 0) -> np.ndarray:
    golden = np.pi * (3 - 5 ** 0.5)
    poses = []
    for i in range(n):
        z = 1 - 2 * (i + 0.5) / n
        z = 0.15 + 0.75 * z
        rho = (1 - z * z) ** 0.5
        th = golden * i + seed * 0.37
        eye = radius * np.array([rho * np.cos(th), rho * np.sin(th), z])
        poses.append(_look_at_rdf(eye, np.zeros(3)))
    return np.stack(poses)


@torch.no_grad()
def _integrate_gt(rays_o, rays_d, n_steps: int = 512, scale: float = 0.5,
                  style: str = "solid", with_depth: bool = False):
    """Premultiplied rgb + alpha (R, 4) of the analytic field; with_depth
    appends the expected distance along the ray, sum w*t (R, 5)."""
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    hits = clamp_near(
        ray_aabb_intersect(rays_o, d, torch.zeros(3),
                           torch.full((3,), scale)), 0.05)
    t1 = torch.clamp_min(hits[:, 0], 0.0)
    t2 = torch.where(hits[:, 1] > 0, hits[:, 1], t1)
    i = (torch.arange(n_steps, dtype=torch.float32, device=d.device)
         + 0.5) / n_steps
    ts = t1[:, None] + (t2 - t1)[:, None] * i[None, :]
    deltas = torch.broadcast_to(((t2 - t1) / n_steps)[:, None], ts.shape)
    xyz = rays_o[:, None] + ts[..., None] * d[:, None]
    sigma, rgb = analytic_field(xyz, style)
    valid = torch.broadcast_to((hits[:, 0] >= 0)[:, None], ts.shape)
    out = composite_rays_train(sigma, rgb, deltas, ts, valid)
    cols = [out["rgb"], out["opacity"][:, None]]
    if with_depth:
        cols.append(out["depth"][:, None])
    return torch.cat(cols, -1)


def render_views(directions, poses, *, scale: float = 0.5,
                 style: str = "solid", with_depth: bool = False,
                 device="cuda") -> np.ndarray:
    """The analytic field's ground truth of each pose: (N, HW, 4)
    premultiplied rgb + alpha, or (N, HW, 5) with the expected ray
    distance, as numpy."""
    dirs = torch.as_tensor(directions, device=device)
    chunk = 1 << 15      # (chunk, 512, 4-object) intermediates ~1 GB
    parts = []
    for p in torch.as_tensor(poses, device=device):
        o, d = get_rays(dirs, p)
        for i in range(0, o.shape[0], chunk):
            parts.append(_integrate_gt(
                o[i:i + chunk], d[i:i + chunk], scale=scale, style=style,
                with_depth=with_depth).cpu())
    return torch.cat(parts).numpy().reshape(len(poses), dirs.shape[0], -1)


@dataclasses.dataclass
class SyntheticDataset:
    """K, directions, poses, rays (white-composited GT images) and
    alphas of the procedural scene, as numpy arrays like the JAX class."""
    root_dir: str = ""
    split: str = "train"
    downsample: float = 1.0
    n_images: int = 50
    img_wh: tuple = (64, 64)
    scale: float = 0.5
    cam_radius: float = 1.2
    seed: int = 0
    style: str = "solid"
    device: str = "cuda"

    def __post_init__(self):
        w, h = (int(self.img_wh[0] * self.downsample),
                int(self.img_wh[1] * self.downsample))
        self.img_wh = (w, h)
        self.K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]],
                          np.float32)
        self.directions = get_ray_directions(h, w, self.K,
                                             device="cpu").numpy()
        seed = self.seed if self.split == "train" else self.seed + 1000
        self.poses = _fibonacci_poses(self.n_images, self.cam_radius, seed)
        cache_dir = Path(os.environ.get("GNT_TORCH_GT_CACHE", _GT_CACHE))
        cache_path = cache_dir / (
            f"gt_{self.split.split('_')[0]}_{self.n_images}x{w}x{h}"
            f"_s{self.scale}_r{self.cam_radius}_seed{seed}"
            f"_{self.style}.npz")
        if cache_path.exists():
            with np.load(cache_path) as z:
                rgba = z["rgba"]
        else:
            rgba = self._render_gt(w, h)
            cache_dir.mkdir(parents=True, exist_ok=True)
            tmp = cache_path.with_suffix(f".tmp{os.getpid()}.npz")
            np.savez_compressed(tmp, rgba=rgba)
            os.replace(tmp, cache_path)
        self.alphas = np.clip(rgba[..., 3], 0.0, 1.0).astype(np.float32)
        self.rays = np.clip(rgba[..., :3] + (1 - self.alphas[..., None]),
                            0.0, 1.0).astype(np.float32)

    def _render_gt(self, w: int, h: int) -> np.ndarray:
        return render_views(self.directions, self.poses, scale=self.scale,
                            style=self.style, device=self.device)

    def __len__(self):
        return 1000 if self.split.startswith("train") else len(self.poses)

    def sample(self, rng, batch_size=8192):
        """A host batch from a numpy Generator: rgb (numpy), img_idxs,
        pix_idxs."""
        img_idxs = rng.integers(0, len(self.poses), batch_size)
        pix_idxs = rng.integers(0, self.img_wh[0] * self.img_wh[1],
                                batch_size)
        return {"rgb": self.rays[img_idxs, pix_idxs],
                "img_idxs": img_idxs, "pix_idxs": pix_idxs}

    def scene(self, images_uint8: bool = False, depths=None):
        """The scene on self.device for the fused train step: images
        (N, HW, 3) (uint8 if asked), per-ray ground-truth alphas (N, HW)
        for training against random backgrounds, poses (N, 3, 4) and
        directions (HW, 3)."""
        imgs = self.rays
        if images_uint8:
            imgs = np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8)
        dev = self.device
        s = dict(images=torch.as_tensor(imgs, device=dev),
                 alphas=torch.as_tensor(self.alphas, device=dev),
                 poses=torch.as_tensor(self.poses, device=dev),
                 directions=torch.as_tensor(self.directions, device=dev))
        if depths is not None:
            s["depths"] = torch.as_tensor(depths, device=dev)
        return s
