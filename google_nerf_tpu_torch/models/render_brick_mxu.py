"""Tile-raster brick renderer on the global worklist (port of the
`kernel="wl"` path of google_nerf_tpu/models/render_brick_mxu.py).

Front end: cone cull -> per-tile front-to-back brick lists -> exact
per-ray hit filter, per chunk of tiles.  Main pass: one tile-major
worklist of real (tile, P-slot group) items over the whole frame per list
segment, rendered by K1 (`brick_field_tiles_wl`).  Groups beyond the
worklist budget, and tiles whose true list outgrew its capacity, are
re-rendered exactly by the drain through K2 (`brick_field_tiles_tp`).

Where JAX jits the frame, the port runs eagerly: `lax.map` over chunks
is a Python loop, and the `lax.cond` around the drain is a host-side
`if need.any()`.  The kernels read the pool in its baked row layout
(n_blocks, Bk^3, 128); the TPU's transposed `poolT` copy is not built.
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import BakedConfig
from google_nerf_tpu_torch.models.encoders import sh_encode_deg4
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_brick import (_refine_lists,
                                                       _tile_cones,
                                                       _tile_lists,
                                                       brick_geometry,
                                                       tile_order)
from google_nerf_tpu_torch.ops.cuda.brick_field import (brick_field_tiles_tp,
                                                        brick_field_tiles_wl,
                                                        window_span)
from google_nerf_tpu_torch.ops.ray_aabb import (clamp_near,
                                                ray_aabb_intersect,
                                                safe_inverse)

SQRT3 = 3.0 ** 0.5
NEAR_DISTANCE = 0.05


def _depth_sorted(bidx, brick_lo, brick_hi, o_t, axis_t):
    """Re-key (T, L) lists to plain front-to-back center depth along the
    tile axis (pads last), keeping list order among equal depths."""
    safe = torch.clamp_min(bidx, 0).long()
    c = (0.5 * (brick_lo + brick_hi))[safe]                   # (T, L, 3)
    t_c = ((c - o_t[:, None, :]) * axis_t[:, None, :]).sum(-1)
    key = torch.where(bidx >= 0, t_c, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(bidx, 1, order)


def _exact_hit_filter(bidx, brick_lo, brick_hi, o3, du3, t1r, t2r, dt,
                      Le: int):
    """Exact per-(candidate, ray) slab/window test + stable compaction.

    bidx (Tb, Lc) depth-sorted candidates (-1 pads); o3/du3 (Tb, 64, 3);
    t1r/t2r (Tb, 64).  Returns ((Tb, Le) lists of true-hit bricks in
    depth order, (Tb,) true-hit counts).  A dropped slot has no (ray,
    window sample) hit, so dropping it is exact."""
    Tb, Lc = bidx.shape
    safe = torch.clamp_min(bidx, 0).long()
    lo_s, hi_s = brick_lo[safe], brick_hi[safe]               # (Tb, Lc, 3)
    inv3 = safe_inverse(du3)
    dt_t = torch.tensor(dt, dtype=torch.float32, device=bidx.device)
    t1b, t2b = t1r[:, None, :], t2r[:, None, :]               # (Tb, 1, 64)
    ta = torch.broadcast_to(t1b, (Tb, Lc, 64))
    tb = torch.broadcast_to(t2b, (Tb, Lc, 64))
    for k in range(3):
        a = (lo_s[:, :, None, k] - o3[:, None, :, k]) * inv3[:, None, :, k]
        b = (hi_s[:, :, None, k] - o3[:, None, :, k]) * inv3[:, None, :, k]
        ta = torch.maximum(ta, torch.minimum(a, b))
        tb = torch.minimum(tb, torch.maximum(a, b))
    n0 = torch.clamp_min(torch.ceil((ta - t1b) / dt_t - 0.5), 0.0)
    n1 = torch.floor((tb - t1b) / dt_t - 0.5)
    hit = ((tb > ta) & (n1 >= n0) & (t2b > 0)
           & (bidx >= 0)[:, :, None])                         # (Tb, Lc, 64)
    hit_any = hit.any(2)
    nhits = hit_any.sum(1).to(torch.int32)
    ar = torch.arange(Lc, dtype=torch.int64, device=bidx.device)
    pose = torch.where(hit_any, ar[None], Lc)
    pose = torch.sort(pose, dim=1).values[:, :Le]
    bidx2 = torch.where(pose < Lc,
                        torch.gather(bidx, 1, pose.clamp_max(Lc - 1)), -1)
    return bidx2, nhits


def _pack_lists(bx, brick_lo, brick_hi):
    """Depth-sorted (Tb, Lx) lists -> (pool_blk, meta, nvalid); pad slots
    (a suffix) repeat the tile's last valid block id."""
    sf = torch.clamp_min(bx, 0).long()
    nv = (bx >= 0).sum(1).to(torch.int32)
    lastv = sf[torch.arange(sf.shape[0], device=sf.device),
               torch.clamp_min(nv.long() - 1, 0)]
    pb = torch.where(bx >= 0, sf, lastv[:, None]).reshape(-1).to(torch.int32)
    meta = torch.cat([brick_lo[sf], brick_hi[sf],
                      torch.zeros(sf.shape + (2,), device=sf.device)],
                     -1).reshape(-1, 8)
    return pb, meta, nv


def _chunk_frontend(brick_lo, brick_hi, rays_o, rays_du, *, cfg, L,
                    max_samples, macro_tiles, macro_L, exact_cull, pbatch):
    """Cull + exact filter + list build for one tile-contiguous ray chunk:
    everything before any kernel runs.  Returns a dict of per-chunk
    tensors."""
    R = rays_o.shape[0]
    T = R // 64
    dt = SQRT3 / max_samples
    hits = ray_aabb_intersect(rays_o, rays_du, torch.zeros(3),
                              torch.full((3,), cfg.scale))
    hits = clamp_near(hits, NEAR_DISTANCE)
    t2 = torch.where(hits[:, 1] > 0, hits[:, 1], 0.0)
    t1 = torch.where(hits[:, 0] >= 0, torch.clamp_min(hits[:, 0], 0.0), 0.0)

    o_t, axis_t, tan_t = _tile_cones(rays_o, rays_du, T, 64)
    t_far = t2.reshape(T, 64).amax(-1)
    if macro_tiles > 1 and macro_L > 0:
        Tm = T // macro_tiles
        o_m, axis_m, tan_m = _tile_cones(rays_o, rays_du, Tm,
                                         64 * macro_tiles)
        t_far_m = t_far.reshape(Tm, macro_tiles).amax(-1)
        midx, m_rel = _tile_lists(brick_lo, brick_hi, o_m, axis_m, tan_m,
                                  t_far_m, L=macro_L)
        bidx, t_rel = _refine_lists(brick_lo, brick_hi, midx, o_t, axis_t,
                                    tan_t, t_far, mt=macro_tiles,
                                    L=min(L, macro_L))
        macro_over = torch.repeat_interleave(m_rel > midx.shape[1],
                                             macro_tiles)
    else:
        bidx, t_rel = _tile_lists(brick_lo, brick_hi, o_t, axis_t, tan_t,
                                  t_far, L=L)
        macro_over = torch.zeros((T,), dtype=torch.bool, device=rays_o.device)
    Lp = bidx.shape[1]
    # plain front-to-back center depth: the selection key's relevance
    # tiers would misorder the in-kernel composite
    bidx = _depth_sorted(bidx, brick_lo, brick_hi, o_t, axis_t)

    nhits = torch.zeros((T,), dtype=torch.int32, device=rays_o.device)
    if exact_cull > 0:
        Le = min(exact_cull, Lp)
        Le = max(pbatch, (Le // pbatch) * pbatch)
        bidx, nhits = _exact_hit_filter(
            bidx, brick_lo, brick_hi, rays_o.reshape(T, 64, 3),
            rays_du.reshape(T, 64, 3), t1.reshape(T, 64),
            t2.reshape(T, 64), dt, Le)

    pool_blk, meta, nvalid = _pack_lists(bidx, brick_lo, brick_hi)
    rays8 = torch.cat([rays_o, rays_du, t1[:, None], t2[:, None]], 1)
    return dict(pool_blk=pool_blk, meta=meta, nvalid=nvalid, nhits=nhits,
                t_rel=t_rel, macro_over=macro_over, rays8=rays8,
                sh=sh_encode_deg4(rays_du), o_t=o_t, axis_t=axis_t,
                tan_t=tan_t, t_far=t_far, t1=t1, t2=t2)


def frontend_caps(L, macro_tiles, macro_L, exact_cull, pbatch, n_bricks):
    """(Lp, L_orig): list capacity after the front end, and before the
    exact filter."""
    L = min(L, n_bricks)
    Lp = min(L, macro_L) if (macro_tiles > 1 and macro_L > 0) else L
    L_orig = Lp
    if exact_cull > 0:
        Le = min(exact_cull, Lp)
        Lp = max(pbatch, (Le // pbatch) * pbatch)
    return Lp, L_orig


def _drain_pass(out, fe, need, miss_sz, fargs, fkw, brick_lo, brick_hi, *,
                D, drain_L, drain_xc, exact_cull, pbatch, dt):
    """Exact overflow drain: re-render up to D needy tiles from scratch
    through compact drain_L-slot extended lists with K2.  Runs only when
    some tile needs it (the host-side form of the JAX lax.cond).
    Returns (out, pairs_undrained, trunc_tiles, drain_slots)."""
    dev = out.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if not bool(need.any()):
        return out, zero, zero, zero
    T = fe["nvalid"].shape[0]
    o_t, axis_t, tan_t, t_far = (fe["o_t"], fe["axis_t"], fe["tan_t"],
                                 fe["t_far"])
    score = torch.where(need, torch.clamp_min(fe["t_rel"], 1), 0)
    # jax.lax.top_k order: highest first, lower index first among ties
    order = torch.sort(score, descending=True, stable=True).indices[:D]
    sc, dtid = score[order], order
    dmask = sc > 0
    bidx_e, rel_e = _tile_lists(brick_lo, brick_hi, o_t[dtid], axis_t[dtid],
                                tan_t[dtid], t_far[dtid], L=drain_L)
    bidx_e = _depth_sorted(bidx_e, brick_lo, brick_hi, o_t[dtid],
                           axis_t[dtid])
    Lcd = drain_L
    over_d = torch.zeros((D,), dtype=torch.int32, device=dev)
    if exact_cull > 0 and drain_xc > 0:
        Lcd = min(drain_xc, drain_L)
        Lcd = max(pbatch, (Lcd // pbatch) * pbatch)
        o3 = fe["rays8"][:, 0:3].reshape(T, 64, 3)
        du3 = fe["rays8"][:, 3:6].reshape(T, 64, 3)
        bidx_e, nh_e = _exact_hit_filter(
            bidx_e, brick_lo, brick_hi, o3[dtid], du3[dtid],
            fe["t1"].reshape(T, 64)[dtid], fe["t2"].reshape(T, 64)[dtid],
            dt, Lcd)
        over_d = torch.clamp_min(nh_e - Lcd, 0)
    pb_e, meta_e, nv_e = _pack_lists(bidx_e, brick_lo, brick_hi)
    out_d = brick_field_tiles_tp(
        pb_e, meta_e, *fargs, tid=dtid,
        lbase=torch.arange(D, dtype=torch.int32, device=dev) * Lcd,
        nslots=torch.where(dmask, nv_e, 0), Lcall=Lcd, **fkw)
    dm_t = torch.zeros((T,), dtype=torch.bool, device=dev)
    dm_t[dtid] = dmask
    out = torch.where(torch.repeat_interleave(dm_t, 64)[:, None], out_d, out)
    missed = need & ~dm_t
    dmiss = torch.clamp_min(rel_e - drain_L, 0) + over_d
    und = (torch.where(missed, miss_sz, 0).sum()
           + torch.where(dmask, dmiss, 0).sum()).to(torch.int32)
    tr = (missed.sum() + (dmask & (dmiss > 0)).sum()).to(torch.int32)
    dsl = torch.where(dmask, nv_e, 0).sum().to(torch.int32)
    return out, und, tr, dsl


@torch.no_grad()
def _wl_frame(pool3, rgb_mlp, lo, hi, ro_ch, rd_ch, inv, *, W, H, Wp, Hp,
              exp_step_factor, cfg, bcfg, L, max_samples, T_threshold,
              macro_tiles, macro_L, drain_tiles, drain_L, pbatch,
              segment_slots, exact_cull, drain_xc, wl_cap):
    """Global worklist frame: the cull/filter front end runs per chunk;
    the kernel grid is ONE tile-major worklist of real (tile, P-slot
    group) items over the whole frame per list segment.  Segments
    re-check per-tile liveness between K1 calls; groups beyond the budget
    drain exactly through K2."""
    n_chunks, cpr = ro_ch.shape[0], ro_ch.shape[1] // 64
    Tg = n_chunks * cpr
    dev = ro_ch.device
    dt = SQRT3 / max_samples
    Lp, L_orig = frontend_caps(L, macro_tiles, macro_L, exact_cull, pbatch,
                               int(lo.shape[0]))
    parts = [_chunk_frontend(lo, hi, ro_ch[c], rd_ch[c], cfg=cfg, L=L,
                             max_samples=max_samples,
                             macro_tiles=macro_tiles, macro_L=macro_L,
                             exact_cull=exact_cull, pbatch=pbatch)
             for c in range(n_chunks)]
    fe = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    del parts
    pool_blk, meta, nvalid = fe["pool_blk"], fe["meta"], fe["nvalid"]
    rays8, sh = fe["rays8"], fe["sh"]
    w1, w2, w3 = (w.contiguous() for w in rgb_mlp)

    Pw = pbatch
    segL = max(Pw, ((segment_slots or Lp) // Pw) * Pw)
    while Lp % segL and segL > Pw:
        segL -= Pw
    if Lp % segL:
        raise ValueError(f"list capacity {Lp} has no {Pw}-aligned segment")
    Gmax = segL // Pw
    cap_wl = min(wl_cap if wl_cap > 0 else max(Tg // 2, 1024), Tg * Gmax)
    tau_max = float(-np.log(T_threshold))
    S = window_span(max_samples, bcfg.block, bcfg.voxel_res, cfg.scale)
    out = torch.zeros((Tg * 64, 8), dtype=torch.float32, device=dev)
    dma_slots = torch.zeros((), dtype=torch.int64, device=dev)
    wl_dropped_t = torch.zeros((Tg,), dtype=torch.int32, device=dev)
    gi = torch.arange(Gmax, device=dev)[None]                 # (1, Gmax)
    stream = torch.arange(Tg * Gmax, device=dev)
    for si in range(Lp // segL):
        s0 = si * segL
        ns_rem = torch.clamp(nvalid - s0, 0, segL)
        live_t = ns_rem > 0
        if si > 0:
            tau_t = out[:, 0].reshape(Tg, 64)
            live_t &= (tau_t < tau_max).any(1)
        ns_eff = torch.where(live_t, ns_rem, 0)
        g_t = (ns_eff + Pw - 1) // Pw                         # (Tg,)
        validg = (gi < g_t[:, None]).reshape(-1)
        # tile-major order of the valid groups, padded to cap_wl
        keyf = torch.where(validg, stream, Tg * Gmax)
        sk, src = torch.sort(keyf, stable=True)
        src, slotv = src[:cap_wl], sk[:cap_wl] < Tg * Gmax
        wt = src // Gmax
        wg = src - wt * Gmax
        nreal = slotv.sum()
        last_wt = wt[torch.clamp(nreal - 1, 0, cap_wl - 1)]
        wt = torch.where(slotv, wt, last_wt)
        wg = torch.where(slotv, wg, 0)
        wlr = wt * Lp + s0 + wg * Pw
        wn = torch.where(slotv, torch.clamp(ns_eff[wt] - wg * Pw, 0, Pw), 0)
        wfl = slotv & (wg == 0)
        # in place: tiles absent from the worklist keep their carry, so
        # JAX's select against the previous `out` is implied
        brick_field_tiles_wl(pool_blk, meta, rays8, sh, pool3, w1, w2, w3,
                             wt, wlr, wn, wfl, S=S, dt=dt, tau_max=tau_max,
                             P=Pw, Bk=bcfg.block, init=out, out=out)
        served_g = torch.clamp(cap_wl - (torch.cumsum(g_t, 0) - g_t), 0, None)
        served_g = torch.minimum(served_g, g_t)
        served = torch.minimum(ns_eff, served_g * Pw)
        dma_slots += served.sum()
        wl_dropped_t += (ns_eff - served).to(torch.int32)

    cap_t = torch.full((Tg,), Lp, dtype=torch.int32, device=dev)
    if exact_cull > 0:
        need = ((fe["nhits"] > cap_t) | fe["macro_over"]
                | (fe["t_rel"] > L_orig))
        miss_sz = (torch.clamp_min(fe["nhits"] - cap_t, 0)
                   + torch.clamp_min(fe["t_rel"] - L_orig, 0))
    else:
        need = (fe["t_rel"] > cap_t) | fe["macro_over"]
        miss_sz = torch.clamp_min(fe["t_rel"] - cap_t, 0)
    need = need | (wl_dropped_t > 0)
    miss_sz = miss_sz + wl_dropped_t
    fargs = (rays8, sh, pool3, w1, w2, w3)
    fkw = dict(S=S, dt=dt, tau_max=tau_max, P=pbatch, Bk=bcfg.block)
    if drain_tiles > 0:
        out, undrained, trunc, drain_slots = _drain_pass(
            out, fe, need, miss_sz, fargs, fkw, lo, hi,
            D=min(drain_tiles, Tg), drain_L=drain_L, drain_xc=drain_xc,
            exact_cull=exact_cull, pbatch=pbatch, dt=dt)
        dma_slots = dma_slots + drain_slots
    else:
        undrained = torch.where(need, miss_sz, 0).sum().to(torch.int32)
        trunc = need.sum().to(torch.int32)

    tau = out[:, 0]
    opacity = torch.clamp(1.0 - torch.exp(-tau), 0.0, 1.0)

    def unpermute(x):
        x = x[:Wp * Hp][inv]
        if (Wp, Hp) != (W, H):
            x = x.reshape((Hp, Wp) + x.shape[1:])[:H, :W]
            x = x.reshape((H * W,) + x.shape[2:])
        return x

    rgb = unpermute(out[:, 1:4])
    opacity_u = unpermute(opacity)
    bg = 1.0 if exp_step_factor == 0.0 else 0.0
    return dict(rgb=rgb + bg * (1.0 - opacity_u[:, None]),
                opacity=opacity_u, depth=unpermute(out[:, 4]),
                trunc_tiles=trunc,
                pairs_rendered=out[:, 5].sum().to(torch.int32),
                pairs_undrained=undrained,
                dma_slots=dma_slots.to(torch.int32))


def render_brick_mxu(baked, cfg: NGPConfig, rays_o, rays_d, W, H, *,
                     bcfg: BakedConfig = BakedConfig(), L: int = 48,
                     max_samples: int = 512, T_threshold: float = 1e-2,
                     chunk_tiles: int = 512, macro_tiles: int = 8,
                     macro_L: int = 1024, geometry=None, kernel: str = "wl",
                     drain_tiles: int = 256, drain_L: int = 256,
                     pbatch: int = 4, segment_slots: int = 0,
                     exact_cull: int = 0, drain_xc: int = 0, wl_cap: int = 0,
                     exp_step_factor: float = 0.0, device="cuda"):
    """Full-frame brick renderer over W*H rays in image row-major order.

    Same arguments as the JAX entry, less `bands` (the worklist subsumes
    band scheduling there too) and `interpret`.  exact_cull > 0 filters
    the wide L-slot cull lists to true-hit bricks; drain_tiles/drain_L/
    drain_xc size the exact overflow drain; wl_cap bounds the worklist
    per segment (0 = max(T/2, 1024)).  `pairs_undrained == 0` certifies
    that every culled-in pair was rendered.  Returns a dict of rgb
    (H*W, 3), opacity, depth and the counters trunc_tiles,
    pairs_rendered, pairs_undrained, dma_slots."""
    if kernel != "wl":
        raise NotImplementedError(
            f"kernel={kernel!r}: the port renders with the worklist kernel "
            "only; the dense n/t/tp frames are ROADMAP item 16 and the rgba "
            "slab is item 18")
    if bcfg.feat_dim != 16:
        raise ValueError("kernel row layout is 8 corners x 16 features")
    if pbatch not in (1, 2, 4, 8, 16):
        raise ValueError(f"pbatch={pbatch} not in (1, 2, 4, 8, 16)")
    tile = 8
    L = max(pbatch, (L // pbatch) * pbatch)
    lo, hi, _ = (geometry if geometry is not None
                 else brick_geometry(baked["block_map"], bcfg, cfg, device))
    lo, hi = lo.to(device), hi.to(device)
    vox = bcfg.block ** 3
    pool3 = baked["pool"].to(device).reshape(-1, vox, 128)
    rgb_mlp = [w.to(device) for w in baked["rgb_mlp"]]
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=device)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=device)
    Wp = ((W + tile - 1) // tile) * tile
    Hp = ((H + tile - 1) // tile) * tile
    if (Wp, Hp) != (W, H):
        col = np.minimum(np.arange(Wp), W - 1)
        row = np.minimum(np.arange(Hp), H - 1)
        sel = torch.as_tensor((row[:, None] * W + col[None]).reshape(-1),
                              device=device)
        rays_o, rays_d = rays_o[sel], rays_d[sel]
    perm, inv = tile_order(Wp, Hp, tile)
    perm = torch.as_tensor(perm, dtype=torch.int64, device=device)
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rdu = rays_d / torch.where(norm > 0, norm, 1.0)
    ro_t, rd_t = rays_o[perm], rdu[perm]

    n_tiles = (Wp * Hp) // 64
    n_bricks = int(lo.shape[0])
    L = min(L, n_bricks)
    cpr = max(min(int(chunk_tiles), n_tiles), 1)
    mL = min(macro_L, n_bricks)
    mt = macro_tiles if mL > 0 else 0
    while mt > 1 and cpr % mt:
        mt //= 2
    n_chunks = -(-n_tiles // cpr)
    pad_rays = n_chunks * cpr * 64 - Wp * Hp
    if pad_rays:
        # pad rays start far outside the scene box: they rasterize nothing
        ro_t = torch.cat([ro_t, torch.full((pad_rays, 3), 100.0,
                                           device=device)])
        rd_t = torch.cat([rd_t, torch.full((pad_rays, 3), 1.0 / SQRT3,
                                           device=device)])
    dL = min(drain_L, n_bricks)
    return _wl_frame(
        pool3, rgb_mlp, lo, hi, ro_t.reshape(n_chunks, cpr * 64, 3),
        rd_t.reshape(n_chunks, cpr * 64, 3),
        torch.as_tensor(inv, dtype=torch.int64, device=device), W=W, H=H,
        Wp=Wp, Hp=Hp, exp_step_factor=exp_step_factor, cfg=cfg, bcfg=bcfg,
        L=L, max_samples=max_samples, T_threshold=T_threshold,
        macro_tiles=mt if mt > 1 else 0, macro_L=mL,
        drain_tiles=min(drain_tiles, cpr),
        drain_L=max(pbatch, (dL // pbatch) * pbatch), pbatch=pbatch,
        segment_slots=segment_slots, exact_cull=exact_cull,
        drain_xc=drain_xc, wl_cap=wl_cap)
