"""Raster front end of the brick renderers (port of the front-end half
of google_nerf_tpu/models/render_brick.py; the XLA pair renderer itself,
`render_brick`, is ROADMAP item 16).

The baked field's occupied bricks are cone-culled per 8x8 ray tile into
front-to-back brick lists.  Selection keeps the JAX tie order: where JAX
takes `lax.top_k` (lower index first among equal keys) or sorts, the
port sorts with `stable=True`.
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import BakedConfig, baked_extent
from google_nerf_tpu_torch.models.ngp import NGPConfig

_TIER_OFFSET = 1.0e6     # > any in-scene ray t; separates selection tiers


def brick_geometry(block_map, bcfg: BakedConfig, cfg: NGPConfig,
                   device=None):
    """World AABBs of the occupied bricks, in pool order.

    Returns (lo, hi, pool_base): (Nb, 3) f32 bounds and the (Nb,) int32
    first pool row of each brick, on `device` (default: block_map's)."""
    if device is None:
        device = block_map.device if torch.is_tensor(block_map) else "cpu"
    bm = (block_map.cpu().numpy() if torch.is_tensor(block_map)
          else np.asarray(block_map))
    Gb, Bk, V = bcfg.block_res, bcfg.block, bcfg.voxel_res
    s = baked_extent(cfg)
    blk_ids = np.flatnonzero(bm >= 0).astype(np.int32)
    blk_ids = blk_ids[np.argsort(bm[blk_ids])]               # pool order
    origin = np.stack([blk_ids // (Gb * Gb), (blk_ids // Gb) % Gb,
                       blk_ids % Gb], -1).astype(np.float32) * Bk
    lo = (origin / V * 2.0 - 1.0) * s
    hi = ((origin + Bk) / V * 2.0 - 1.0) * s
    pool_base = (bm[blk_ids] * (Bk ** 3)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (lo, hi, pool_base))


def tile_order(W: int, H: int, tile: int):
    """Permutation grouping pixel rays tile by tile (row-major tiles,
    row-major inside a tile) and its inverse, as numpy int32."""
    idx = np.arange(W * H, dtype=np.int32).reshape(H, W)
    Ty, Tx = H // tile, W // tile
    perm = (idx.reshape(Ty, tile, Tx, tile).transpose(0, 2, 1, 3)
            .reshape(-1))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def _tile_cones(rays_o, rays_du, n_tiles: int, tpx: int):
    """Per-tile bounding cone of the tile's unit ray directions:
    (apex o, axis, tan of the half-angle)."""
    d = rays_du.reshape(n_tiles, tpx, 3)
    axis = d.mean(1)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    cos_min = torch.amin((d * axis[:, None, :]).sum(-1), 1)
    cos_min = torch.clamp(cos_min, 1e-3, 1.0)
    tan_half = torch.sqrt(1.0 - cos_min ** 2) / cos_min
    o = rays_o.reshape(n_tiles, tpx, 3)[:, 0]
    return o, axis, tan_half


def _cone_keys(c, r_b, o, axis, tan_half, t_far):
    """Selection keys of bricks (centers c, radii r_b) against T cones:
    key = center depth + a tier offset for bricks that pass only through
    the conservative r_b margin (+inf = irrelevant)."""
    v = c - o[:, None, :]                                     # (T, N, 3)
    t_c = (v * axis[:, None, :]).sum(-1)
    rad2 = (v * v).sum(-1) - t_c ** 2
    lim = t_c * tan_half[:, None] + r_b * (1.0 + tan_half[:, None])
    relevant = (t_c > -r_b) & (t_c < t_far[:, None] + r_b) \
        & (rad2 <= lim * lim)
    lim0 = torch.clamp_min(t_c, 0.0) * tan_half[:, None]
    tier = torch.where(rad2 <= lim0 * lim0, 0.0, _TIER_OFFSET)
    key = torch.where(relevant, t_c + tier, torch.inf)
    return key, relevant


def _smallest(key, L: int):
    """(values, indices) of the L smallest keys per row, ascending, lower
    index first among ties (jax.lax.top_k(-key, L) order)."""
    vals, idx = torch.sort(key, dim=1, stable=True)
    return vals[:, :L], idx[:, :L]


def _tile_lists(brick_lo, brick_hi, o, axis, tan_half, t_far, *, L: int):
    """Keep the L most relevant bricks per cone.  Returns (T, L) brick
    ids (-1 pad) and each cone's true relevant count."""
    c = (0.5 * (brick_lo + brick_hi))[None]                   # (1, Nb, 3)
    r_b = (0.5 * torch.linalg.norm(brick_hi - brick_lo, dim=-1))[None]
    key, relevant = _cone_keys(c, r_b, o, axis, tan_half, t_far)
    n_rel = relevant.sum(-1).to(torch.int32)
    vals, bidx = _smallest(key, L)
    bidx = torch.where(torch.isfinite(vals), bidx, -1)
    return bidx.to(torch.int32), n_rel


def _refine_lists(brick_lo, brick_hi, midx, o, axis, tan_half, t_far, *,
                  mt: int, L: int):
    """Narrow each macro group's candidates (midx (Tm, Lm), -1 pad) down
    to each of its `mt` member tiles' own nearest-L list."""
    safe = torch.clamp_min(midx, 0).long()
    c_all = 0.5 * (brick_lo + brick_hi)
    r_all = 0.5 * torch.linalg.norm(brick_hi - brick_lo, dim=-1)
    c = torch.repeat_interleave(c_all[safe], mt, dim=0)       # (T, Lm, 3)
    r_b = torch.repeat_interleave(r_all[safe], mt, dim=0)
    cand = torch.repeat_interleave(safe, mt, dim=0)
    cand_valid = torch.repeat_interleave(midx >= 0, mt, dim=0)
    key, relevant = _cone_keys(c, r_b, o, axis, tan_half, t_far)
    key = torch.where(cand_valid, key, torch.inf)
    relevant &= cand_valid
    n_rel = relevant.sum(-1).to(torch.int32)
    vals, sel = _smallest(key, L)
    bidx = torch.gather(cand, 1, sel)
    bidx = torch.where(torch.isfinite(vals), bidx, -1)
    return bidx.to(torch.int32), n_rel
