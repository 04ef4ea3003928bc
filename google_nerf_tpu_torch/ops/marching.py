"""Cascade selection for the cascaded occupancy lookup (port of
mip_from_pos and mip_from_dt in google_nerf_tpu/ops/marching.py; the
dense marchers `march_rays_train` and `march_rays_test_round` are
ROADMAP item 14)."""
from __future__ import annotations

import torch


def mip_from_pos(xyz, cascades: int):
    """Cascade from position: |xyz| in [0,.5)->0, [.5,1)->1, [1,2)->2, ..."""
    _, e = torch.frexp(xyz.abs().amax(-1))   # mx = m * 2^e, m in [0.5, 1)
    return torch.clamp(e + 1, 0, cascades - 1)


def mip_from_dt(dt, grid_size: int, cascades: int):
    """Cascade from step size: dt*G in [0,1)->0, [1,2)->1, [2,4)->2, ..."""
    _, e = torch.frexp(dt * grid_size)
    return torch.clamp(e, 0, cascades - 1)
