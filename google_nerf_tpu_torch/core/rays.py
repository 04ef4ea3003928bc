"""Camera and ray math (port of google_nerf_tpu/core/rays.py).

Camera math stays in full fp32: the JAX reference asks for
`Precision.HIGHEST`, so the products here are elementwise multiply-adds
in float32, never a reduced-precision matmul.
"""
from __future__ import annotations

import torch


def pixel_grid(H: int, W: int, device="cuda") -> torch.Tensor:
    """(H, W, 2) grid of (u=col, v=row) pixel coordinates (no +0.5)."""
    u = torch.arange(W, dtype=torch.float32, device=device)
    v = torch.arange(H, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def get_ray_directions(H, W, K, *, convention: str = "rdf", flatten=True,
                       return_uv=False, device="cuda"):
    """Per-pixel camera-space ray directions through pixel centers.

    convention 'rdf' = [right down front], 'rub' = [right up back]."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    grid = pixel_grid(H, W, device)
    u, v = grid[..., 0], grid[..., 1]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (u - cx + 0.5) / fx
    y = (v - cy + 0.5) / fy
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


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-space directions (N, 3) and c2w (3, 4) or (N, 3, 4) ->
    world rays_o, rays_d (N, 3); rays_d is not normalized."""
    directions = torch.as_tensor(directions, dtype=torch.float32)
    c2w = torch.as_tensor(c2w, dtype=torch.float32,
                          device=directions.device)
    R = c2w[..., :3]
    if c2w.ndim == 2:
        R = R[None]
    # sum_c d_c * R_rc as explicit fp32 multiply-adds (no TF32 matmul)
    rays_d = (directions[:, None, :] * R).sum(-1)
    rays_o = torch.broadcast_to(c2w[..., 3], rays_d.shape)
    return rays_o, rays_d
