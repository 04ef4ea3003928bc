"""Camera and ray math (port of google_nerf_tpu/core/rays.py).

Camera math stays in full fp32: the JAX reference asks for
`Precision.HIGHEST`, so the products here are elementwise multiply-adds
in float32, never a reduced-precision matmul.
"""
from __future__ import annotations

import numpy as np
import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] over a last axis of 3, as three products
    added in order: the same bits on the CPU and the card (a reduction
    kernel may add them in another order)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over a last axis of 3, in dot3's order."""
    n = torch.sqrt(dot3(v, v))
    return n[..., None] if keepdim else n


def pixel_grid(H: int, W: int, device="cuda") -> torch.Tensor:
    """(H, W, 2) grid of (u=col, v=row) pixel coordinates (no +0.5)."""
    u = torch.arange(W, dtype=torch.float32, device=device)
    v = torch.arange(H, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def get_ray_directions(H, W, K, *, convention: str = "rdf", random=False,
                       generator=None, flatten=True, return_uv=False,
                       device="cuda"):
    """Per-pixel camera-space ray directions through pixel centers, or
    with `random` through a uniform point of each pixel (drawn from
    `generator`, u's jitter first, then v's).

    convention 'rdf' = [right down front], 'rub' = [right up back]."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    grid = pixel_grid(H, W, device)
    u, v = grid[..., 0], grid[..., 1]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if random:
        ju = torch.rand(u.shape, generator=generator, device=device)
        jv = torch.rand(v.shape, generator=generator, device=device)
    else:
        ju = jv = 0.5
    x = (u - cx + ju) / fx
    y = (v - cy + jv) / fy
    z = torch.ones_like(u)
    if convention == "rdf":
        directions = torch.stack([x, y, z], -1)
    elif convention == "rub":
        directions = torch.stack([x, -y, -z], -1)
    else:
        raise ValueError(f"unknown camera convention {convention!r}")
    if flatten:
        directions = directions.reshape(-1, 3)
        grid = grid.reshape(-1, 2)
    if return_uv:
        return directions, grid
    return directions


# ScanNet aliases: the fork's conventions (no axis flips; v2 is OpenGL's)
def get_ray_directions_scannet(H, W, K, **kw):
    return get_ray_directions(H, W, K, convention="rdf", **kw)


def get_ray_directions_scannet_v2(H, W, K, **kw):
    return get_ray_directions(H, W, K, convention="rub", **kw)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-space directions (N, 3) and c2w (3, 4) or (N, 3, 4) ->
    world rays_o, rays_d (N, 3); rays_d is not normalized."""
    directions = torch.as_tensor(directions, dtype=torch.float32)
    c2w = torch.as_tensor(c2w, dtype=torch.float32,
                          device=directions.device)
    R = c2w[..., :3]
    if c2w.ndim == 2:
        R = R[None]
    # sum_c d_c * R_rc as fp32 products added in order (no TF32 matmul)
    rays_d = dot3(directions[:, None, :], R)
    rays_o = torch.broadcast_to(c2w[..., 3], rays_d.shape)
    return rays_o, rays_d


def axisangle_to_R(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle (B, 3) -> rotation matrices (B, 3, 3) by Rodrigues'
    formula; the skew square is an fp32 elementwise product-sum."""
    v = torch.as_tensor(v, dtype=torch.float32)
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1),
    ], dim=1)
    norm = (torch.linalg.norm(v, dim=1) + 1e-7)[:, None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    skew2 = (skew[:, :, :, None] * skew[:, None, :, :]).sum(2)
    return (eye + torch.sin(norm) / norm * skew
            + (1 - torch.cos(norm)) / norm ** 2 * skew2)


# Pose normalisation helpers (numpy, on the host at dataset build time).

def _normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray, pts3d: np.ndarray) -> np.ndarray:
    """(N, 3, 4) poses + (M, 3) points -> (3, 4) average pose."""
    center = pts3d.mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, pts3d: np.ndarray):
    """Recenter poses and points around the average pose; the points
    keep a trailing homogeneous column, as the reference's do."""
    pose_avg = average_poses(poses, pts3d)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    pose_avg_inv = np.linalg.inv(pose_avg_homo)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (pose_avg_inv @ poses_homo)[:, :3]
    pts3d_centered = pts3d @ pose_avg_inv[:, :3].T + pose_avg_inv[:, 3:].T
    return poses_centered, pts3d_centered


def create_spheric_poses(radius: float, mean_h: float, n_poses: int = 120):
    """(n_poses, 3, 4) circular camera path around the z axis."""
    def spheric_pose(theta, phi, r):
        trans_t = np.array([[1, 0, 0, 0],
                            [0, 1, 0, 2 * mean_h],
                            [0, 0, 1, -r]], dtype=np.float64)
        rot_phi = np.array([[1, 0, 0],
                            [0, np.cos(phi), -np.sin(phi)],
                            [0, np.sin(phi), np.cos(phi)]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta)],
                              [0, 1, 0],
                              [np.sin(theta), 0, np.cos(theta)]])
        c2w = rot_theta @ rot_phi @ trans_t
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]],
                        dtype=np.float64) @ c2w

    return np.stack([spheric_pose(th, -np.pi / 12, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]])
