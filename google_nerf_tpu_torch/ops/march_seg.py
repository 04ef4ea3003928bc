"""Segment ray marching (port of google_nerf_tpu/ops/march_seg.py).

The same affine candidate lattice as the dense marcher (t_i = t0 + i*dt,
dt = sqrt(3)/max_samples), found with few occupancy lookups:

  phase 0 (sup > 1): one candidate per super-segment of sup*seg
          candidates against the super-dilated bit 2; the first
          n_keep_sup live super-segments descend;
  phase 1: one lookup per segment of `seg` candidates: the 3^3 block word
          at the min endpoint cell where a segment spans < 2 cells per
          axis, else the Chebyshev-dilated bit 1; the first n_keep live
          segments are kept;
  phase 2: every candidate of a kept segment against the exact bit (one
          block word per group of g candidates where g > 1); the first K
          hits are compacted.

occ_u8 is grid.pack_occupancy_u8's int32 word grid.  Constant-step
scenes only.
"""
from __future__ import annotations

import math

import torch

from google_nerf_tpu_torch.ops.marching import _first_k_occupied as _first_k
from google_nerf_tpu_torch.ops.marching import mip_from_dt, mip_from_pos

SQRT3 = 3.0 ** 0.5


def required_dilation_radius(seg: int, grid_size: int, max_samples: int,
                             scale: float) -> int:
    """Chebyshev radius (cells) such that if any candidate cell in a
    segment is occupied, the segment-center cell's dilated bit is set
    (the finest cascade, mip_bound = min(1, scale), has the smallest
    cells)."""
    dt = SQRT3 / max_samples
    cell = 2.0 * min(1.0, scale) / grid_size
    half_span = 0.5 * (seg - 1) * dt / cell
    return max(1, math.ceil(half_span + 1.0))


def _raster(n, grid_size: int):
    return (n[..., 0] * grid_size + n[..., 1]) * grid_size + n[..., 2]


def _occ_bits_lookup(occ_u8, xyz, dt, cascades: int, scale: float,
                     grid_size: int, bit: int):
    """Cascaded lookup of one bit of the packed occupancy word grid."""
    if cascades == 1:
        idx = _raster(_cell_index_single(xyz, scale, grid_size), grid_size)
    else:
        mip = torch.maximum(mip_from_pos(xyz, cascades),
                            mip_from_dt(dt, grid_size, cascades))
        mip_bound = torch.clamp_max(torch.exp2(mip.to(torch.float32) - 1.0),
                                    scale)
        nf = torch.clamp(0.5 * (xyz / mip_bound[..., None] + 1.0)
                         * grid_size, 0.0, grid_size - 1.0)
        n = nf.to(torch.int32)
        idx = ((mip * grid_size + n[..., 0]) * grid_size + n[..., 1]) \
            * grid_size + n[..., 2]
    word = occ_u8.reshape(-1)[idx.long()]
    return ((word >> bit) & 1) > 0


def _word_group(seg: int, dt: float, scale: float, grid_size: int) -> int:
    """Largest divisor g of `seg` such that g consecutive candidates span
    < 2 cells per axis, so the 3^3 block word at the group's min cell
    answers the exact test for the whole group; 1 when none is safe."""
    bound = min(0.5, scale)
    g = seg
    while g > 1 and (g - 1) * dt * grid_size / (2.0 * bound) >= 2.0:
        g //= 2
    return g


def _cell_index_single(xyz, scale: float, grid_size: int):
    """Single-cascade cell integer coords (int32), as JAX's: clip the
    unit-cube position to [0, 1 - 0.5/G], scale by G, truncate."""
    bound = min(0.5, scale)
    nf = torch.clamp((0.5 / bound) * xyz + 0.5, 0.0,
                     1.0 - 0.5 / grid_size) * grid_size
    return nf.to(torch.int32)


def _occ_block_lookup(occ_u8, xyz, scale: float, grid_size: int, g: int):
    """Exact occupancy through 3^3 block words, one lookup per group of g
    consecutive candidates.  xyz (..., n, 3), n divisible by g -> (..., n)
    bool.  Single cascade; group cell span < 2 per axis (_word_group)."""
    n = _cell_index_single(xyz, scale, grid_size)            # (..., n, 3)
    ng = n.reshape(n.shape[:-2] + (n.shape[-2] // g, g, 3))
    m = torch.clamp_max(ng.amin(-2), grid_size - 3)          # (..., q, 3)
    w = occ_u8.reshape(-1)[_raster(m, grid_size).long()]     # (..., q)
    d = ng - m[..., None, :]                                 # in {0, 1, 2}
    bit = 3 + (d[..., 0] * 9 + d[..., 1] * 3 + d[..., 2])
    return (((w[..., None] >> bit) & 1) > 0).reshape(n.shape[:-1])


def _seg_live_block(occ_u8, rays_o, rays_d, t_first, seg: int, dt,
                    scale: float, grid_size: int):
    """Conservative segment liveness from ONE block word per segment: any
    set bit of the 3^3 block anchored at the min endpoint cell.  Valid
    when _word_group(seg) == seg.  rays_o/rays_d (R, 3) broadcast against
    t_first (R, ...)."""
    shape = (rays_o.shape[0],) + (1,) * (t_first.ndim - 1) + (3,)
    o, d = rays_o.reshape(shape), rays_d.reshape(shape)
    na = _cell_index_single(o + t_first[..., None] * d, scale, grid_size)
    nb = _cell_index_single(o + (t_first + (seg - 1) * dt)[..., None] * d,
                            scale, grid_size)
    m = torch.clamp_max(torch.minimum(na, nb), grid_size - 3)
    w = occ_u8.reshape(-1)[_raster(m, grid_size).long()]
    return (w >> 3) != 0


def _last_end(t0, idx, valid, span: int, dt: float):
    """t0 + (last valid index + 1) * span * dt (index -1 where none is),
    multiplied in JAX's order."""
    last = torch.where(valid, idx, -1).amax(-1).to(torch.float32)
    return t0 + (last + 1.0) * span * dt


def march_rays_train_seg(rays_o, rays_d, hits_t, occ_u8, *, cascades: int,
                         scale: float, grid_size: int, max_samples: int,
                         k_samples: int, noise, seg: int = 8,
                         n_keep: int = 32, sup: int = 0,
                         n_keep_sup: int = 12):
    """Constant-step segment marcher -> padded (R, K) samples: xyzs, dirs
    (R, K, 3), deltas, ts, valid (R, K), truncated (R,), t_resume (R,)
    (the earliest lattice point that may hold unexamined content; inf
    where nothing was truncated) and total_samples.

    occ_u8: pack_occupancy_u8's grid, dilated by at least
    required_dilation_radius(seg, ...) (and, with sup > 1, super-dilated
    by required_dilation_radius(sup*seg, ...)).  noise (R,) in [0, 1)."""
    R = rays_o.shape[0]
    dev = rays_o.device
    dt = SQRT3 / max_samples
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    t0 = torch.clamp_min(t1, 0.0) + dt * noise
    o, d = rays_o.detach(), rays_d.detach()
    n_segs = max_samples // seg
    n_keep = min(n_keep, n_segs)
    k_samples = min(k_samples, n_keep * seg)
    block_words = (cascades == 1
                   and _word_group(seg, dt, scale, grid_size) == seg)
    inf = torch.full((R,), math.inf, device=dev)

    if sup > 1:
        # ---- phase 0: super-segment test (bit 2)
        n_sup = n_segs // sup
        ar = torch.arange(n_sup, dtype=torch.float32, device=dev)
        jsup = ar * (sup * seg) + (sup * seg - 1) / 2
        ts_sup = t0[:, None] + jsup[None, :] * dt
        xyz_sup = o[:, None, :] + ts_sup[..., None] * d[:, None, :]
        live_sup = _occ_bits_lookup(occ_u8, xyz_sup,
                                    torch.full_like(ts_sup, dt), cascades,
                                    scale, grid_size, bit=2)
        sup_start = t0[:, None] + (ar * sup * seg)[None, :] * dt
        live_sup = live_sup & (sup_start < t2[:, None]) & hit[:, None]
        nk_sup = min(n_keep_sup, n_sup)
        sup_idx, sup_valid = _first_k(live_sup, nk_sup)      # (R, nk_sup)

        # ---- phase 1: segment liveness inside live super-segments
        sub = torch.arange(sup, dtype=torch.float32, device=dev)
        js0 = (sup_idx.to(torch.float32)[..., None] * sup + sub) * seg
        seg_start_t = t0[:, None, None] + js0 * dt           # (R, nk, sup)
        if block_words:
            live = _seg_live_block(occ_u8, o, d, seg_start_t, seg, dt,
                                   scale, grid_size)
        else:
            ts_mid = seg_start_t + (seg - 1) / 2 * dt
            xyz_mid = o[:, None, None, :] \
                + ts_mid[..., None] * d[:, None, None, :]
            live = _occ_bits_lookup(occ_u8, xyz_mid,
                                    torch.full_like(ts_mid, dt), cascades,
                                    scale, grid_size, bit=1)
        live = (live & (seg_start_t < t2[:, None, None])
                & sup_valid[..., None]).reshape(R, -1)
        seg_global = (sup_idx[..., None] * sup + torch.arange(
            sup, device=dev)).reshape(R, -1)
        pick, seg_valid = _first_k(live, min(n_keep, live.shape[-1]))
        seg_idx = torch.gather(seg_global, 1, pick)
        n_keep = pick.shape[-1]
        # t_resume: past the last kept super-segment / segment (a kept
        # segment may hold no exact candidate, so resuming after the last
        # valid sample could make no progress)
        trunc_sup = live_sup.sum(-1) > nk_sup
        trunc_seg = live.sum(-1) > n_keep
        sup_end = _last_end(t0, sup_idx, sup_valid, sup * seg, dt)
        seg_end = _last_end(t0, seg_idx, seg_valid, seg, dt)
        t_resume = torch.minimum(torch.where(trunc_sup, sup_end, inf),
                                 torch.where(trunc_seg, seg_end, inf))
        truncated = trunc_sup | trunc_seg
    else:
        # ---- phase 1: per-segment liveness
        ar = torch.arange(n_segs, dtype=torch.float32, device=dev)
        seg_start_t = t0[:, None] + (ar * seg)[None, :] * dt  # (R, S)
        if block_words:
            live = _seg_live_block(occ_u8, o, d, seg_start_t, seg, dt,
                                   scale, grid_size)
        else:
            js = ar * seg + (seg - 1) / 2
            ts_mid = t0[:, None] + js[None, :] * dt
            xyz_mid = o[:, None, :] + ts_mid[..., None] * d[:, None, :]
            live = _occ_bits_lookup(occ_u8, xyz_mid,
                                    torch.full_like(ts_mid, dt), cascades,
                                    scale, grid_size, bit=1)
        live = live & (seg_start_t < t2[:, None]) & hit[:, None]
        seg_idx, seg_valid = _first_k(live, n_keep)          # (R, n_keep)
        truncated = live.sum(-1) > n_keep
        t_resume = torch.where(
            truncated, _last_end(t0, seg_idx, seg_valid, seg, dt), inf)

    # ---- phase 2: exact test inside kept segments
    base = seg_idx.to(torch.float32) * seg                   # (R, n_keep)
    off = torch.arange(seg, dtype=torch.float32, device=dev)
    ts_c = t0[:, None, None] + (base[..., None] + off) * dt  # (R, nk, seg)
    xyz_c = o[:, None, None, :] + ts_c[..., None] * d[:, None, None, :]
    g = _word_group(seg, dt, scale, grid_size) if cascades == 1 else 1
    if g > 1:
        occ = _occ_block_lookup(occ_u8, xyz_c, scale, grid_size, g)
    else:
        occ = _occ_bits_lookup(occ_u8, xyz_c, torch.full_like(ts_c, dt),
                               cascades, scale, grid_size, bit=0)
    cand_ok = (occ & (ts_c < t2[:, None, None])
               & seg_valid[..., None]).reshape(R, -1)
    ts_flat = ts_c.reshape(R, -1)

    if k_samples >= cand_ok.shape[-1]:
        # every candidate slot is kept: valid slots stay in ascending-t
        # flat order, all that the packing and composite need
        valid = cand_ok
        ts = torch.where(valid, ts_flat, 0.0)
    else:
        idx, valid = _first_k(cand_ok, k_samples)
        trunc2 = cand_ok.sum(-1) > k_samples
        ts = torch.where(valid, torch.gather(ts_flat, 1, idx), 0.0)
        # kept samples are the first k in ascending t: unexamined content
        # starts right after the last one
        t_resume = torch.minimum(t_resume, torch.where(
            trunc2, torch.where(valid, ts, 0.0).amax(-1) + dt, inf))
        truncated = truncated | trunc2
    deltas = torch.where(valid, dt, 0.0)
    xyzs = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    return dict(xyzs=xyzs, dirs=dirs, deltas=deltas, ts=ts, valid=valid,
                truncated=truncated, t_resume=t_resume,
                total_samples=valid.sum())
