"""Ray/AABB slab test and ray/sphere intersection (port of
google_nerf_tpu/ops/ray_aabb.py)."""
from __future__ import annotations

import torch


def safe_inverse(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| pushed to at least 1e-10, keeping its sign (>= 0 -> +)."""
    return 1.0 / torch.where(d.abs() > 1e-10, d,
                             torch.where(d >= 0, 1e-10, -1e-10))


def ray_aabb_intersect(rays_o, rays_d, center, half_size):
    """rays_o, rays_d: (N, 3); center, half_size: (3,).

    Returns hits_t (N, 2) = [max(t1, 0), t2], both -1 where the ray misses."""
    dev = rays_o.device
    center = torch.as_tensor(center, dtype=torch.float32,
                             device=dev).reshape(1, 3)
    half = torch.as_tensor(half_size, dtype=torch.float32,
                           device=dev).reshape(1, 3)
    inv_d = safe_inverse(rays_d)
    t_lo = (center - half - rays_o) * inv_d
    t_hi = (center + half - rays_o) * inv_d
    t1 = torch.minimum(t_lo, t_hi).amax(-1)
    t2 = torch.maximum(t_lo, t_hi).amin(-1)
    t1 = torch.clamp_min(t1, 0.0)
    hit = t2 > t1
    return torch.where(hit[:, None], torch.stack([t1, t2], -1),
                       torch.full_like(rays_o[:, :2], -1.0))


def ray_sphere_intersect(rays_o, rays_d, center, radius: float):
    """Analytic ray/sphere test.  rays_o, rays_d: (N, 3); center: (3,).

    Returns hits_t (N, 2) = [max(t1, 0), t2], both -1 where the ray misses."""
    center = torch.as_tensor(center, dtype=torch.float32,
                             device=rays_o.device).reshape(1, 3)
    oc = rays_o - center
    a = (rays_d * rays_d).sum(-1)
    b = 2.0 * (oc * rays_d).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = torch.clamp_min((-b - sq) / (2 * a), 0.0)
    t2 = (-b + sq) / (2 * a)
    hit = (disc > 0) & (t2 > t1)
    return torch.where(hit[:, None], torch.stack([t1, t2], -1),
                       torch.full_like(rays_o[:, :2], -1.0))


def clamp_near(hits_t, near: float):
    """Push valid near bounds below `near` out to `near`."""
    t1 = hits_t[:, 0]
    t1 = torch.where((t1 >= 0) & (t1 < near), near, t1)
    return torch.stack([t1, hits_t[:, 1]], -1)
