"""Tile-rasterized baked-brick renderer (port of
google_nerf_tpu/models/render_brick.py): the raster front end that the
kernel renderers share, and `render_brick`, the pair renderer with no
kernel.

The baked field's occupied bricks are cone-culled per ray tile into
front-to-back brick lists; each ray's exact slab windows against its
tile's list become (ray, brick) pairs; the pairs are packed into a
budget (sample-major, so a short budget drops far tails), the baked
field is evaluated on each pair's lattice window (one pool row a
sample, the rgb MLP per sample) and composited inside the pair, then
across each ray's ordered pairs.  With `pass_fracs` the pairs instead
run one per live ray a pass, then an exact drain takes the rest.

Selection keeps the JAX tie order: where JAX takes `lax.top_k` (lower
index first among equal keys) or sorts, the port sorts with
`stable=True`.
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import (BakedConfig, _voxel_coords,
                                                baked_extent, trilerp_rows)
from google_nerf_tpu_torch.models.encoders import sh_encode_deg4
from google_nerf_tpu_torch.models.mlp import mlp_apply
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.ops.compaction import pack, plan_packing, unpack
from google_nerf_tpu_torch.ops.ray_aabb import (clamp_near,
                                                ray_aabb_intersect,
                                                safe_inverse)
from google_nerf_tpu_torch.ops.trunc_exp import trunc_exp

SQRT3 = 3.0 ** 0.5
NEAR_DISTANCE = 0.05
_MISS_N0 = np.iinfo(np.int32).max // 2      # a missed pair sorts last

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


def _pair_windows(rays_o, rays_du, t1, t2, brick_lo, brick_hi, pool_base,
                  bidx_tile, tpx, dt):
    """Exact slab tests of each ray against its tile's brick list ->
    per-(ray, l) lattice window n0..n1 (n0 = _MISS_N0, n1 = -1 on a miss)
    and pool base.  Lattice: t = t1 + (n + 0.5) * dt."""
    T, L = bidx_tile.shape
    safe = torch.clamp_min(bidx_tile, 0).long()
    lo = brick_lo[safe][:, None]                              # (T, 1, L, 3)
    hi = brick_hi[safe][:, None]
    o = rays_o.reshape(T, tpx, 1, 3)
    inv_d = safe_inverse(rays_du).reshape(T, tpx, 1, 3)
    t_lo = (lo - o) * inv_d
    t_hi = (hi - o) * inv_d
    ta = torch.minimum(t_lo, t_hi).amax(-1).reshape(-1, L)    # (R, L)
    tb = torch.maximum(t_lo, t_hi).amin(-1).reshape(-1, L)
    ta = torch.maximum(ta, t1[:, None])
    tb = torch.minimum(tb, t2[:, None])
    dt_t = torch.tensor(dt, dtype=torch.float32, device=rays_o.device)
    n0 = torch.clamp_min(torch.ceil((ta - t1[:, None]) / dt_t - 0.5), 0.0)
    n1 = torch.floor((tb - t1[:, None]) / dt_t - 0.5)
    hit = (torch.repeat_interleave(bidx_tile >= 0, tpx, dim=0) & (tb > ta)
           & (n1 >= n0))
    pb = torch.repeat_interleave(pool_base[safe], tpx, dim=0)  # (R, L)
    # windows are cast only where they hit: a miss's bounds may be far
    # outside int32
    return (torch.where(hit, n0, 0.0).to(torch.int32).masked_fill(~hit,
                                                                 _MISS_N0),
            torch.where(hit, n1, -1.0).to(torch.int32),
            torch.where(hit, pb, 0))


def _pair_field(pool, rgb_mlp, rays_o, rays_du, t1, p_n0, p_n1, p_pb, p_ray,
                slot_valid, *, dt, S, V, Bk, s, F):
    """The baked field on the packed (P, S) sample windows, composited
    inside each pair -> (pair_tau, pair_rgb, pair_dep)."""
    P = p_n0.shape[0]
    dev = p_n0.device
    n = p_n0[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None]
    ts = t1[p_ray][:, None] + (n.to(torch.float32) + 0.5) * dt
    s_valid = (n <= p_n1[:, None]) & slot_valid[:, None]
    rd = rays_du[p_ray]
    xyz = rays_o[p_ray][:, None, :] + ts[..., None] * rd[:, None, :]
    v0, frac = _voxel_coords(xyz, s, V)
    local = torch.clamp(v0 - torch.div(v0, Bk, rounding_mode="floor") * Bk,
                        0, Bk - 1)
    lid = (local[..., 0] * Bk + local[..., 1]) * Bk + local[..., 2]
    row_idx = torch.where(s_valid, p_pb[:, None] + lid, 0)
    h = trilerp_rows(pool[row_idx.reshape(-1)], frac.reshape(P * S, 3))
    sigma = torch.where(s_valid.reshape(-1), trunc_exp(h[:, 0]), 0.0)
    sh = sh_encode_deg4(rd)                                   # per pair
    rgb_in = torch.cat([sh[:, None, :].expand(P, S, sh.shape[-1])
                        .reshape(P * S, -1), h], -1)
    rgb_s = torch.sigmoid(mlp_apply(rgb_mlp, rgb_in,
                                    compute_dtype=torch.bfloat16))
    sd = torch.clamp_max(sigma.reshape(P, S) * dt, 80.0)
    w = torch.exp(-(torch.cumsum(sd, -1) - sd)) * (1.0 - torch.exp(-sd))
    return (sd.sum(-1), (w[..., None] * rgb_s.reshape(P, S, 3)).sum(1),
            (w * ts).sum(-1))


def _combine(pair_tau, pair_rgb, pair_dep, plan, R, Lk, tau0, T_threshold):
    """Per-ray composite over the ordered pairs with exclusive
    transmittance, after a carried optical depth tau0 (R,) or 0."""
    tau_g = unpack(pair_tau, plan).reshape(R, Lk)
    rgb_g = unpack(pair_rgb, plan).reshape(R, Lk, 3)
    dep_g = unpack(pair_dep, plan).reshape(R, Lk)
    incl = torch.cumsum(tau_g, -1)
    if tau0 is not None:
        incl = tau0[:, None] + incl
    T_bef = torch.exp(-(incl - tau_g))
    live = T_bef > T_threshold
    Tl = torch.where(live, T_bef, 0.0)
    return ((Tl[..., None] * rgb_g).sum(1), (Tl * dep_g).sum(1),
            torch.where(live, tau_g, 0.0).sum(-1))


def _render_tiles(pool, rgb_mlp, brick_lo, brick_hi, pool_base, rays_o,
                  rays_du, *, cfg: NGPConfig, bcfg: BakedConfig, tile: int,
                  L: int, Lk: int, S: int, max_samples: int,
                  T_threshold: float, pairs_budget: int,
                  pass_fracs: tuple = (), drain_frac: float = 0.25,
                  macro_tiles: int = 0, macro_L: int = 0):
    """Render one tile-contiguous chunk of rays: rgb, opacity, depth and
    the telemetry trunc_tiles, trunc_rays, pairs_dropped, pairs_total."""
    R = rays_o.shape[0]
    dev = rays_o.device
    tpx = tile * tile
    T = R // tpx
    dt = SQRT3 / max_samples
    hits = ray_aabb_intersect(rays_o, rays_du, torch.zeros(3, device=dev),
                              torch.full((3,), cfg.scale, device=dev))
    hits = clamp_near(hits, NEAR_DISTANCE)
    t2 = torch.where(hits[:, 1] > 0, hits[:, 1], 0.0)
    t1 = torch.where(hits[:, 0] >= 0, torch.clamp_min(hits[:, 0], 0.0), 0.0)

    # cone cull -> per-tile nearest-L lists (hierarchical with macro tiles)
    o_t, axis_t, tan_t = _tile_cones(rays_o, rays_du, T, tpx)
    t_far = t2.reshape(T, tpx).amax(-1)
    if macro_tiles > 1 and macro_L > 0:
        Tm = T // macro_tiles
        o_m, axis_m, tan_m = _tile_cones(rays_o, rays_du, Tm,
                                         tpx * macro_tiles)
        t_far_m = t_far.reshape(Tm, macro_tiles).amax(-1)
        midx, m_rel = _tile_lists(brick_lo, brick_hi, o_m, axis_m, tan_m,
                                  t_far_m, L=macro_L)
        bidx, t_rel = _refine_lists(brick_lo, brick_hi, midx, o_t, axis_t,
                                    tan_t, t_far, mt=macro_tiles,
                                    L=min(L, macro_L))
        tile_over = ((t_rel > bidx.shape[1])
                     | torch.repeat_interleave(m_rel > midx.shape[1],
                                               macro_tiles))
    else:
        bidx, t_rel = _tile_lists(brick_lo, brick_hi, o_t, axis_t, tan_t,
                                  t_far, L=L)
        tile_over = t_rel > bidx.shape[1]

    # exact per-ray windows; each ray's pairs front to back by entry index
    # (a stable sort: misses, at _MISS_N0, go last; JAX's top_k order)
    n0, n1, pb = _pair_windows(rays_o, rays_du, t1, t2, brick_lo, brick_hi,
                               pool_base, bidx, tpx, dt)
    Lk = min(Lk, bidx.shape[1])
    ray_over = ((n1 >= n0).sum(-1) > Lk if Lk < bidx.shape[1]
                else torch.zeros(R, dtype=torch.bool, device=dev))
    n0, sel = torch.sort(n0, dim=1, stable=True)
    n0, sel = n0[:, :Lk], sel[:, :Lk]
    n1, pb = torch.gather(n1, 1, sel), torch.gather(pb, 1, sel)
    pair_valid = n1 >= n0
    pairs_total = pair_valid.sum().to(torch.int32)

    def field(plan, rays, w0, w1, base):
        """The pairs (ray, window w0..w1, pool base) the plan packs."""
        return _pair_field(
            pool, rgb_mlp, rays_o, rays_du, t1, pack(w0, plan),
            pack(w1, plan), pack(base, plan), pack(rays, plan),
            plan.slot_valid, dt=dt, S=S, V=bcfg.voxel_res, Bk=bcfg.block,
            s=baked_extent(cfg), F=bcfg.feat_dim)

    ridx = torch.arange(R, dtype=torch.int32, device=dev)
    every_pair = (ridx[:, None].expand(R, Lk).reshape(-1), n0.reshape(-1),
                  n1.reshape(-1), pb.reshape(-1))
    if not pass_fracs:
        # every content pair at once, sample-major under the budget
        pairs_budget = min(pairs_budget, R * Lk)
        plan = plan_packing(pair_valid, pairs_budget, sample_major=True)
        rgb, depth, tau_tot = _combine(*field(plan, *every_pair), plan, R,
                                       Lk, None, T_threshold)
        dropped = torch.clamp_min(plan.n_valid - pairs_budget, 0)
    else:
        # one pair per live ray a pass (a ray that missed a pass's budget
        # retries), then an exact packed drain of what is left
        tau_max = -float(np.log(T_threshold))
        n_valid_r = pair_valid.sum(-1)
        cur = torch.zeros(R, dtype=torch.int64, device=dev)
        tau_tot = torch.zeros(R, device=dev)
        rgb = torch.zeros((R, 3), device=dev)
        depth = torch.zeros(R, device=dev)
        for frac in pass_fracs[:Lk]:
            B_p = max(128, int(np.ceil(frac * R / 128)) * 128)
            m = (tau_tot < tau_max) & (cur < n_valid_r)
            plan = plan_packing(m[:, None], B_p)
            cc = torch.clamp_max(cur, Lk - 1)[:, None]
            pair_tau, pair_rgb, pair_dep = field(
                plan, ridx, *(torch.gather(a, 1, cc)[:, 0]
                              for a in (n0, n1, pb)))
            rendered = m & plan.keep.reshape(R)
            T_bef = torch.where(rendered, torch.exp(-tau_tot), 0.0)
            rgb = rgb + T_bef[:, None] * unpack(pair_rgb, plan).reshape(R, 3)
            depth = depth + T_bef * unpack(pair_dep, plan).reshape(R)
            tau_tot = tau_tot + torch.where(
                rendered, unpack(pair_tau, plan).reshape(R), 0.0)
            cur = cur + rendered.long()
        col = torch.arange(Lk, device=dev)[None]
        rest_valid = ((col < n_valid_r[:, None]) & (col >= cur[:, None])
                      & (tau_tot < tau_max)[:, None])
        B_d = max(128, int(np.ceil(drain_frac * R / 128)) * 128)
        plan = plan_packing(rest_valid, B_d, sample_major=True)
        d_rgb, d_dep, d_tau = _combine(*field(plan, *every_pair), plan, R,
                                       Lk, tau_tot, T_threshold)
        rgb, depth, tau_tot = rgb + d_rgb, depth + d_dep, tau_tot + d_tau
        dropped = torch.clamp_min(plan.n_valid - B_d, 0)

    opacity = torch.clamp(1.0 - torch.exp(-tau_tot), 0.0, 1.0)
    return dict(rgb=rgb, opacity=opacity, depth=depth,
                trunc_tiles=tile_over.sum().to(torch.int32),
                trunc_rays=(ray_over & (t2 > 0)).sum().to(torch.int32),
                pairs_dropped=dropped.to(torch.int32),
                pairs_total=pairs_total)


def tile_stream(rays_o, rays_d, W: int, H: int, tile: int, device):
    """W*H rays in image row-major order -> the tile-ordered stream the
    renderers march: (rays_o, unit rays_d, inv, Wp, Hp), the image
    edge-replicated out to a tile multiple (Wp, Hp) and inv the
    permutation back to row-major order."""
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=device)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=device)
    Wp = ((W + tile - 1) // tile) * tile
    Hp = ((H + tile - 1) // tile) * tile
    if (Wp, Hp) != (W, H):
        # edge-replicate the ray grid out to a tile multiple; the extra
        # rays render normally and are cropped from the output
        col = np.minimum(np.arange(Wp), W - 1)
        row = np.minimum(np.arange(Hp), H - 1)
        sel = torch.as_tensor((row[:, None] * W + col[None]).reshape(-1),
                              device=device)
        rays_o, rays_d = rays_o[sel], rays_d[sel]
    perm, inv = tile_order(Wp, Hp, tile)
    perm = torch.as_tensor(perm, dtype=torch.int64, device=device)
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rdu = rays_d / torch.where(norm > 0, norm, 1.0)
    inv = torch.as_tensor(inv, dtype=torch.int64, device=device)
    return rays_o[perm], rdu[perm], inv, Wp, Hp


def pad_stream(ro_t, rd_t, n_tiles: int, tpx: int):
    """The stream padded by n_tiles tiles of rays that start far outside
    the scene box: they hit nothing."""
    if not n_tiles:
        return ro_t, rd_t
    dev = ro_t.device
    return (torch.cat([ro_t, torch.full((n_tiles * tpx, 3), 100.0,
                                        device=dev)]),
            torch.cat([rd_t, torch.full((n_tiles * tpx, 3), 1.0 / SQRT3,
                                        device=dev)]))


def render_stream(baked, geometry, cfg: NGPConfig, ro_t, rd_t, *,
                  bcfg: BakedConfig, tile: int, L: int, Lk: int,
                  max_samples: int, T_threshold: float, chunk_tiles: int,
                  pairs_per_ray: float, pass_fracs: tuple,
                  drain_frac: float, macro_tiles: int, macro_L: int):
    """Render a tile-ordered stream in chunks of chunk_tiles tiles (a
    partial last chunk padded to the chunk's size): rgb, opacity and
    depth per ray of the stream (pad rays included), the counters
    trunc_tiles, trunc_rays, pairs_dropped, pairs_total summed over the
    chunks, and pairs_per_chunk."""
    lo, hi, pool_base = geometry
    pool, rgb_mlp = baked["pool"], baked["rgb_mlp"]
    tpx = tile * tile
    n_tiles = ro_t.shape[0] // tpx
    n_bricks = int(lo.shape[0])
    L = min(L, n_bricks)
    Lk = min(Lk, L)
    # longest lattice window inside one brick: brick diagonal / dt
    vox_w = 2.0 * baked_extent(cfg) / bcfg.voxel_res
    S = int(np.ceil(bcfg.block * vox_w * SQRT3 / (SQRT3 / max_samples))) + 1
    # the chunk never exceeds the stream's tiles
    cpr = max(min(int(chunk_tiles), n_tiles), 1)
    mL = min(macro_L, n_bricks)
    mt = macro_tiles if mL > 0 else 0
    while mt > 1 and cpr % mt:
        mt //= 2
    outs = []
    for i in range(0, n_tiles, cpr):
        n_c = min(cpr, n_tiles - i)
        ro_c, rd_c = pad_stream(ro_t[i * tpx:(i + n_c) * tpx],
                                rd_t[i * tpx:(i + n_c) * tpx], cpr - n_c,
                                tpx)
        outs.append(_render_tiles(
            pool, rgb_mlp, lo, hi, pool_base, ro_c, rd_c, cfg=cfg,
            bcfg=bcfg, tile=tile, L=L, Lk=Lk, S=S, max_samples=max_samples,
            T_threshold=T_threshold,
            pairs_budget=int(cpr * tpx * pairs_per_ray),
            pass_fracs=tuple(pass_fracs), drain_frac=drain_frac,
            macro_tiles=mt if mt > 1 else 0, macro_L=mL))
    cat = {k: (torch.cat([o[k] for o in outs]) if outs[0][k].ndim
               else torch.stack([o[k] for o in outs]).sum())
           for k in outs[0]}
    cat["pairs_per_chunk"] = torch.stack([o["pairs_total"] for o in outs])
    return cat


def frame_of_stream(cat, inv, W: int, H: int, Wp: int, Hp: int,
                    bg: float):
    """rgb (over the background bg), opacity and depth of the stream's
    first Wp*Hp rays back in row-major order, cropped to W x H."""
    def unpermute(x):
        x = x[:Wp * Hp][inv]
        if (Wp, Hp) != (W, H):
            x = x.reshape((Hp, Wp) + x.shape[1:])[:H, :W]
            x = x.reshape((H * W,) + x.shape[2:])
        return x

    opacity = unpermute(cat["opacity"])
    return dict(rgb=unpermute(cat["rgb"]) + bg * (1.0 - opacity[:, None]),
                opacity=opacity, depth=unpermute(cat["depth"]))


def on_device(baked, geometry, bcfg, cfg, device):
    """The bake's pool and rgb MLP and its brick geometry (built when
    None) on device."""
    geometry = (geometry if geometry is not None else
                brick_geometry(baked["block_map"], bcfg, cfg, device))
    return (dict(pool=baked["pool"].to(device),
                 rgb_mlp=[w.to(device) for w in baked["rgb_mlp"]]),
            tuple(a.to(device) for a in geometry))


@torch.no_grad()
def render_brick(baked, cfg: NGPConfig, rays_o, rays_d, W, H, *,
                 bcfg: BakedConfig = BakedConfig(), tile: int = 8,
                 L: int = 256, Lk: int = 24, max_samples: int = 512,
                 T_threshold: float = 1e-2, chunk_tiles: int = 2048,
                 pairs_per_ray: float = 4.0, exp_step_factor: float = 0.0,
                 geometry=None, pass_fracs: tuple = (),
                 drain_frac: float = 0.25, macro_tiles: int = 8,
                 macro_L: int = 1024, device="cuda"):
    """Full-frame pair renderer over W*H rays in image row-major order,
    JAX's arguments.  `geometry`: brick_geometry's output, to skip its
    rebuild.  Returns rgb (H*W, 3), opacity, depth and the counters
    trunc_tiles, trunc_rays, pairs_dropped, pairs_total (summed over
    chunks) and pairs_per_chunk."""
    baked, geometry = on_device(baked, geometry, bcfg, cfg, device)
    ro_t, rd_t, inv, Wp, Hp = tile_stream(rays_o, rays_d, W, H, tile,
                                          device)
    cat = render_stream(
        baked, geometry, cfg, ro_t, rd_t, bcfg=bcfg, tile=tile, L=L, Lk=Lk,
        max_samples=max_samples, T_threshold=T_threshold,
        chunk_tiles=chunk_tiles, pairs_per_ray=pairs_per_ray,
        pass_fracs=pass_fracs, drain_frac=drain_frac,
        macro_tiles=macro_tiles, macro_L=macro_L)
    bg = 1.0 if exp_step_factor == 0.0 else 0.0
    return dict(frame_of_stream(cat, inv, W, H, Wp, Hp, bg),
                **{k: cat[k] for k in ("trunc_tiles", "trunc_rays",
                                       "pairs_dropped", "pairs_total",
                                       "pairs_per_chunk")})
