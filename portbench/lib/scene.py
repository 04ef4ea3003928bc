"""The benchmark's own copy of the procedural scene: the analytic
textured field (three shelled spheres and a box with surface
displacement and a 3-D checker albedo), its camera poses, pixel rays and
ground-truth images by a dense 512-step integration.

It is plain PyTorch and imports nothing of the program, so the
program's training set and the reference's are the same tensors, made
here on the device.  The numbers follow the port's synthetic dataset
(textured style, scale 0.5, camera radius 1.2, focal = width).
"""
from __future__ import annotations

import math

import numpy as np
import torch

SPHERES = (
    ((0.16, 0.02, 0.03), 0.17, (0.90, 0.20, 0.20)),
    ((-0.20, 0.10, 0.05), 0.14, (0.20, 0.50, 0.90)),
    ((0.00, -0.17, -0.12), 0.11, (0.95, 0.80, 0.20)),
)
BOX = ((0.0, 0.20, 0.12), (0.20, 0.05, 0.14), (0.30, 0.85, 0.40))
SIGMA_MAX = 80.0
EDGE = 0.005
SHELL = 0.035
NEAR = 0.05


def analytic_field(xyz: torch.Tensor):
    """xyz (..., 3) -> sigma (...,), rgb (..., 3) of the textured scene."""
    t = lambda v: torch.tensor(v, dtype=xyz.dtype, device=xyz.device)  # noqa
    k1, k2 = 41.0, 19.0
    bump = (torch.sin(k1 * xyz[..., 0]) * torch.sin(k1 * xyz[..., 1])
            * torch.sin(k1 * xyz[..., 2])
            + 0.5 * torch.sin(k2 * (xyz[..., 0] + 1.7 * xyz[..., 1]
                                    - 0.6 * xyz[..., 2]))) / 1.5
    disp = 0.012 * bump
    sigs, cols = [], []
    for (c, r, col) in SPHERES:
        d = torch.linalg.norm(xyz - t(c), dim=-1) + disp
        inside = torch.sigmoid((r - d) / EDGE)
        inside = inside * torch.sigmoid((d - (r - SHELL)) / EDGE)
        sigs.append(inside)
        cols.append(t(col))
    bc, bh, bcol = (t(v) for v in BOX)
    db = torch.amax(torch.abs(xyz - bc) - bh, dim=-1) + disp
    inside = torch.sigmoid(-db / EDGE) * torch.sigmoid((db + SHELL) / EDGE)
    sigs.append(inside)
    cols.append(bcol)
    s = torch.stack(sigs, -1)
    sigma = SIGMA_MAX * torch.amax(s, -1)
    w = s / torch.clamp_min(s.sum(-1, keepdim=True), 1e-8)
    rgb = w @ torch.stack(cols)
    parity = torch.remainder(torch.floor((xyz + 1.0) * 14.0).sum(-1), 2.0)
    rgb = rgb * (0.45 + 0.4 * parity[..., None]) \
        + (1.0 - rgb) * 0.15 * (1.0 - parity[..., None])
    rgb = torch.clamp(rgb * (0.9 + 0.25 * bump[..., None]), 0.0, 1.0)
    return sigma, rgb


def look_at(eye: np.ndarray) -> np.ndarray:
    """c2w (3, 4) looking at the origin, [right down front] axes."""
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.98:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], 1).astype(np.float32)


def fibonacci_poses(n: int, radius: float, seed: int = 0) -> np.ndarray:
    """(n, 3, 4) poses on a Fibonacci spiral of the upper sphere band."""
    golden = np.pi * (3 - 5 ** 0.5)
    out = []
    for i in range(n):
        z = 0.15 + 0.75 * (1 - 2 * (i + 0.5) / n)
        rho = (1 - z * z) ** 0.5
        th = golden * i + seed * 0.37
        out.append(look_at(radius * np.array([rho * np.cos(th),
                                              rho * np.sin(th), z])))
    return np.stack(out)


def orbit_poses(n: int, radius: float, elevation_deg: float) -> np.ndarray:
    """(n, 3, 4) poses evenly spaced in azimuth on one circle."""
    el = math.radians(elevation_deg)
    out = []
    for i in range(n):
        az = 2 * math.pi * i / n
        out.append(look_at(radius * np.array([
            math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
            math.sin(el)])))
    return np.stack(out)


def intrinsics(w: int, h: int) -> np.ndarray:
    return np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)


def pixel_directions(w: int, h: int, device) -> torch.Tensor:
    """(h*w, 3) camera-space directions through pixel centres, focal w."""
    u = torch.arange(w, dtype=torch.float32, device=device)
    v = torch.arange(h, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    x = (uu - w / 2 + 0.5) / w
    y = (vv - h / 2 + 0.5) / w
    return torch.stack([x, y, torch.ones_like(x)], -1).reshape(-1, 3)


def rays(directions: torch.Tensor, c2w: torch.Tensor):
    """World rays (origins, unnormalised directions) of one pose; the
    rotation as three products added in order (no reduced-precision
    matmul)."""
    p = directions[:, None, :] * c2w[:, :3][None]
    d = p[..., 0] + p[..., 1] + p[..., 2]
    return c2w[:, 3].expand(d.shape), d


def aabb_hits(o: torch.Tensor, d: torch.Tensor, half: float):
    """Slab test against the cube [-half, half]^3, with the near clamp:
    (R, 2) [t1, t2], both -1 where the ray misses."""
    inv = 1.0 / torch.where(d.abs() > 1e-10, d,
                            torch.where(d >= 0, 1e-10, -1e-10))
    lo = (-half - o) * inv
    hi = (half - o) * inv
    t1 = torch.clamp_min(torch.minimum(lo, hi).amax(-1), 0.0)
    t2 = torch.maximum(lo, hi).amin(-1)
    hit = t2 > t1
    t1 = torch.where(hit, t1, -1.0)
    t2 = torch.where(hit, t2, -1.0)
    t1 = torch.where((t1 >= 0) & (t1 < NEAR), NEAR, t1)
    return torch.stack([t1, t2], -1)


@torch.no_grad()
def ground_truth(o: torch.Tensor, d: torch.Tensor, scale: float = 0.5,
                 n_steps: int = 512):
    """Premultiplied rgb (R, 3) and alpha (R,) of the analytic field by
    a midpoint integration of n_steps between the box hits."""
    du = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    hits = aabb_hits(o, du, scale)
    t1 = torch.clamp_min(hits[:, 0], 0.0)
    t2 = torch.where(hits[:, 1] > 0, hits[:, 1], t1)
    i = (torch.arange(n_steps, dtype=torch.float32, device=d.device)
         + 0.5) / n_steps
    ts = t1[:, None] + (t2 - t1)[:, None] * i[None, :]
    delta = ((t2 - t1) / n_steps)[:, None]
    sigma, rgb = analytic_field(o[:, None] + ts[..., None] * du[:, None])
    sd = torch.where((hits[:, :1] >= 0), sigma * delta, 0.0)
    T = torch.exp(-(torch.cumsum(sd, -1) - sd))
    w = T * (1.0 - torch.exp(-sd))
    return (w[..., None] * rgb).sum(1), w.sum(-1)


@torch.no_grad()
def training_scene(n_views: int, w: int, h: int, device, *,
                   radius: float = 1.2, chunk: int = 1 << 15):
    """The training captures on the device: images (N, HW, 3) composited
    onto white, alphas (N, HW), poses (N, 3, 4), directions (HW, 3), K
    and the poses as numpy.  Fixed for every seed: the seed changes the
    weights and the draws, never the scene."""
    poses_np = fibonacci_poses(n_views, radius)
    K = intrinsics(w, h)
    dirs = pixel_directions(w, h, device)
    poses = torch.as_tensor(poses_np, device=device)
    imgs, alphas = [], []
    for p in poses:
        o, d = rays(dirs, p)
        for i in range(0, o.shape[0], chunk):
            rgb, a = ground_truth(o[i:i + chunk], d[i:i + chunk])
            a = torch.clamp(a, 0.0, 1.0)
            imgs.append(torch.clamp(rgb + (1.0 - a)[:, None], 0.0, 1.0))
            alphas.append(a)
    return dict(images=torch.cat(imgs).reshape(n_views, -1, 3),
                alphas=torch.cat(alphas).reshape(n_views, -1),
                poses=poses, directions=dirs, K=K, poses_np=poses_np,
                img_wh=(w, h))


@torch.no_grad()
def occupancy(grid_size: int, scale: float, device, threshold: float = 1.0):
    """(1, G, G, G) bool: cells whose centre has analytic sigma above
    threshold (the geometry a trained field's grid converges to)."""
    s = min(0.5, scale)
    c = (torch.arange(grid_size, device=device, dtype=torch.float32)
         + 0.5) / grid_size
    c = (c * 2 - 1) * s
    xyz = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    sigma, _ = analytic_field(xyz.reshape(-1, 3))
    return (sigma > threshold).reshape(1, grid_size, grid_size, grid_size)
