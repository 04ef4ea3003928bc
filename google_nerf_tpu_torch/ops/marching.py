"""Occupancy-guided ray marching over a dense candidate lattice (port of
google_nerf_tpu/ops/marching.py).

Every ray is marched over a fixed lattice of candidate steps; the
occupancy of all candidates is tested at once and the first K occupied
ones are compacted per ray, giving a padded (R, K) sample grid with a
validity mask: static shapes, no host read.

Step rule (vren's calc_dt):
    dt(t) = clamp(t * exp_step_factor, SQRT3 / max_samples,
                  SQRT3 * 2 * scale / grid_size)
With exp_step_factor == 0 the lattice is affine, t_i = t0 + i * dt;
otherwise each step is dt of the step before, walked one step at a time
as JAX's scan walks it.  Cascade (mip) selection is vren's mip_from_pos
/ mip_from_dt.
"""
from __future__ import annotations

import torch

SQRT3 = 3.0 ** 0.5


def calc_dt(t, exp_step_factor: float, max_samples: int, grid_size: int,
            scale: float):
    return torch.clamp(t * exp_step_factor, SQRT3 / max_samples,
                       SQRT3 * 2.0 * scale / grid_size)


def mip_from_pos(xyz, cascades: int):
    """Cascade from position: |xyz| in [0,.5)->0, [.5,1)->1, [1,2)->2, ..."""
    _, e = torch.frexp(xyz.abs().amax(-1))   # mx = m * 2^e, m in [0.5, 1)
    return torch.clamp(e + 1, 0, cascades - 1)


def mip_from_dt(dt, grid_size: int, cascades: int):
    """Cascade from step size: dt*G in [0,1)->0, [1,2)->1, [2,4)->2, ..."""
    _, e = torch.frexp(dt * grid_size)
    return torch.clamp(e, 0, cascades - 1)


def occupancy_lookup(occ_grid, xyz, dt, cascades: int, scale: float,
                     grid_size: int):
    """The cascaded boolean grid occ_grid (C, G, G, G) at world positions
    xyz (..., 3) with step sizes dt (...) -> bool (...)."""
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dt, grid_size, cascades))
    mip_bound = torch.clamp_max(torch.exp2(mip.to(torch.float32) - 1.0),
                                scale)
    nf = torch.clamp(0.5 * (xyz / mip_bound[..., None] + 1.0) * grid_size,
                     0.0, grid_size - 1.0)
    n = nf.to(torch.int32)
    idx = ((mip * grid_size + n[..., 0]) * grid_size + n[..., 1]) \
        * grid_size + n[..., 2]
    return occ_grid.reshape(-1)[idx.long()]


def candidate_ts(t_start, n_cand: int, exp_step_factor: float,
                 max_samples: int, grid_size: int, scale: float,
                 noise=None):
    """Per-ray candidate positions and step sizes (R, n_cand) from the
    first in-box t (R,); with noise (R,) the first sample is jittered by
    noise * dt, as vren's training marcher does."""
    dt0 = calc_dt(t_start, exp_step_factor, max_samples, grid_size, scale)
    t0 = t_start if noise is None else t_start + dt0 * noise
    if exp_step_factor == 0.0:
        dt = SQRT3 / max_samples
        i = torch.arange(n_cand, dtype=torch.float32, device=t0.device)
        ts = t0[:, None] + i[None, :] * dt
        return ts, torch.full_like(ts, dt)
    ts, dts, t = [], [], t0
    for _ in range(n_cand):
        dt = calc_dt(t, exp_step_factor, max_samples, grid_size, scale)
        ts.append(t)
        dts.append(dt)
        t = t + dt
    return torch.stack(ts, 1), torch.stack(dts, 1)


def _first_k_occupied(cand_ok, K: int):
    """The first K True entries along the last axis of cand_ok (..., N):
    their indices in ascending order, and whether each pick is a True
    entry.  topk on JAX's score (-index where True): the True entries'
    scores are unique, so they come out in index order; the other picks
    are masked by every caller."""
    n = cand_ok.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=cand_ok.device)
    score = torch.where(cand_ok, -iota, -(n + 1))
    vals, idx = torch.topk(score, K, dim=-1)
    return idx, vals > -(n + 1)


def march_rays_train(rays_o, rays_d, hits_t, occ_grid, *, cascades: int,
                     scale: float, exp_step_factor: float, grid_size: int,
                     max_samples: int, k_samples: int, noise):
    """Training-time marcher -> padded (R, K) sample grid.

    rays_o/rays_d (R, 3), rays_d unit; hits_t (R, 2) from
    ray_aabb_intersect, near clamped; occ_grid (C, G, G, G) bool; noise
    (R,) in [0, 1).  Returns xyzs, dirs (R, K, 3), deltas, ts, valid
    (R, K), truncated (R,) and total_samples."""
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    ts_c, dts_c = candidate_ts(torch.clamp_min(t1, 0.0).detach(),
                               max_samples, exp_step_factor, max_samples,
                               grid_size, scale, noise=noise)
    xyz_c = rays_o.detach()[:, None, :] \
        + ts_c[..., None] * rays_d.detach()[:, None, :]
    occ = occupancy_lookup(occ_grid, xyz_c, dts_c, cascades, scale,
                           grid_size)
    cand_ok = occ & (ts_c < t2[:, None]) & hit[:, None]
    idx, valid = _first_k_occupied(cand_ok, k_samples)
    ts = torch.where(valid, torch.gather(ts_c, 1, idx), 0.0)
    deltas = torch.where(valid, torch.gather(dts_c, 1, idx), 0.0)
    xyzs = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    return dict(xyzs=xyzs, dirs=dirs, deltas=deltas, ts=ts, valid=valid,
                truncated=cand_ok.sum(-1) > k_samples,
                total_samples=valid.sum())


def march_rays_test_round(rays_o, rays_d, t_cur, t2, alive, occ_grid, *,
                          cascades: int, scale: float, exp_step_factor: float,
                          grid_size: int, max_samples: int, n_cand: int,
                          k_samples: int):
    """One round of test-time marching from per-ray resume positions:
    a window of n_cand candidates from t_cur, its first k_samples
    occupied ones, and t_next: past the window if it held <= k_samples
    occupied candidates, else the lattice successor of the last one
    kept (the rest waits for the next round)."""
    ts_c, dts_c = candidate_ts(t_cur, n_cand + 1, exp_step_factor,
                               max_samples, grid_size, scale)
    ts_succ = ts_c[:, 1:]                  # lattice successor of each cand
    ts_w, dts_w = ts_c[:, :n_cand], dts_c[:, :n_cand]
    window_end = ts_c[:, n_cand]
    xyz_c = rays_o[:, None, :] + ts_w[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(occ_grid, xyz_c, dts_w, cascades, scale,
                           grid_size)
    cand_ok = occ & (ts_w < t2[:, None]) & alive[:, None]
    idx, valid = _first_k_occupied(cand_ok, k_samples)
    ts = torch.where(valid, torch.gather(ts_w, 1, idx), 0.0)
    deltas = torch.where(valid, torch.gather(dts_w, 1, idx), 0.0)
    xyzs = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    count = cand_ok.sum(-1)
    last_idx = torch.where(valid, idx, 0).amax(-1)
    t_next = torch.where(count <= k_samples, window_end,
                         torch.gather(ts_succ, 1, last_idx[:, None])[:, 0])
    t_next = torch.where(alive, t_next, t_cur)
    return dict(xyzs=xyzs, dirs=dirs, deltas=deltas, ts=ts, valid=valid,
                t_next=t_next)
