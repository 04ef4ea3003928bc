"""Tile-raster brick renderer (port of
google_nerf_tpu/models/render_brick_mxu.py).

Front end: cone cull -> per-tile front-to-back brick lists -> exact
per-ray hit filter, per chunk of tiles.  Two frames render the lists:

  * `_mxu_frame` (kernel "n", "t", "tp", "rgba"): per chunk, the dense
    tile grid of K3 (`brick_field_tiles`), K4 (`brick_field_tiles_t`),
    K2 (`brick_field_tiles_tp`) or K5 (`brick_field_tiles_rgba`), flat,
    in occupancy bands, or in list segments with dead-tile elision
    (tp and rgba, through the kernels' init carry);
  * `_wl_frame` (kernel "wl"): one tile-major worklist of real (tile,
    P-slot group) items over the whole frame per list segment, rendered
    by K1 (`brick_field_tiles_wl`).

Tiles whose true list outgrew its capacity (or the worklist budget) are
re-rendered exactly by the drain through the frame's own tile kernel.

Where JAX jits the frame, the port runs eagerly: `lax.map` over chunks
is a Python loop, and the `lax.cond` around the drain is a host-side
`if need.any()`.  K1-K3 read the pool in its baked row layout (n_blocks,
Bk^3, 128); K4 reads the transposed copy, cached as `baked["poolT"]` as
the JAX renderer does, and K5 the per-frame `baked["poolRGBA"]`.
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
from google_nerf_tpu_torch.ops.cuda.brick_field import (
    brick_field_tiles, brick_field_tiles_rgba, brick_field_tiles_t,
    brick_field_tiles_tp, brick_field_tiles_wl, window_span)
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
                    max_samples, macro_tiles, macro_L, exact_cull, align):
    """Cull + exact filter + list build for one tile-contiguous ray chunk:
    everything before any kernel runs.  align: the list slots a kernel
    step reads (pbatch for tp and wl, else 1).  Returns a dict of
    per-chunk tensors."""
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
        Le = max(align, (Le // align) * align)
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


def frontend_caps(L, macro_tiles, macro_L, exact_cull, align, n_bricks):
    """(Lp, L_orig): list capacity after the front end, and before the
    exact filter."""
    L = min(L, n_bricks)
    Lp = min(L, macro_L) if (macro_tiles > 1 and macro_L > 0) else L
    L_orig = Lp
    if exact_cull > 0:
        Le = min(exact_cull, Lp)
        Lp = max(align, (Le // align) * align)
    return Lp, L_orig


def _drain_pass(out, fe, need, miss_sz, field, fargs, fkw, brick_lo,
                brick_hi, *, D, drain_L, drain_xc, exact_cull, align, dt):
    """Exact overflow drain: re-render up to D needy tiles from scratch
    through compact drain_L-slot extended lists with the frame's tile
    kernel `field`.  Runs only when some tile needs it (the host-side
    form of the JAX lax.cond).  Returns (out, pairs_undrained,
    trunc_tiles, drain_slots)."""
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
        Lcd = max(align, (Lcd // align) * align)
        o3 = fe["rays8"][:, 0:3].reshape(T, 64, 3)
        du3 = fe["rays8"][:, 3:6].reshape(T, 64, 3)
        bidx_e, nh_e = _exact_hit_filter(
            bidx_e, brick_lo, brick_hi, o3[dtid], du3[dtid],
            fe["t1"].reshape(T, 64)[dtid], fe["t2"].reshape(T, 64)[dtid],
            dt, Lcd)
        over_d = torch.clamp_min(nh_e - Lcd, 0)
    pb_e, meta_e, nv_e = _pack_lists(bidx_e, brick_lo, brick_hi)
    out_d = field(
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


def _field(kernel: str, pbatch: int, Bk: int):
    """The frame's tile kernel with the common signature (pool_blk, meta,
    rays8, sh, pool3, w1, w2, w3, **list args).  The kernel names are
    looked up at call time, so a caller may swap a module-level kernel
    for its plain version or a recorder."""
    if kernel in ("tp", "wl"):
        # "wl" renders its main pass on the worklist and drains with K2
        return lambda *a, **k: brick_field_tiles_tp(*a, P=pbatch, Bk=Bk, **k)
    if kernel == "t":
        return lambda *a, **k: brick_field_tiles_t(*a, Bk=Bk, **k)
    if kernel == "rgba":
        # pre-shaded slabs: pool3 is the (nb, 32, vox) rgba pool and the
        # sh and MLP arguments are unused
        return (lambda pb, mt, r8, _sh, p3, _w1, _w2, _w3, **k:
                brick_field_tiles_rgba(pb, mt, r8, p3, Bk=Bk, **k))
    return lambda *a, **k: brick_field_tiles(*a, Bk=Bk, **k)


def _finish(out, counters, inv, *, W, H, Wp, Hp, exp_step_factor):
    """Tile-ordered (T*64, 8) state -> the frame dict in image order."""
    opacity = torch.clamp(1.0 - torch.exp(-out[:, 0]), 0.0, 1.0)

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
                **{k: v.to(torch.int32) for k, v in counters.items()})


def _mxu_tiles(pool3, rgb_mlp, brick_lo, brick_hi, rays_o, rays_du, *, cfg,
               bcfg, L, max_samples, T_threshold, macro_tiles, macro_L,
               kernel, bands, drain_tiles, drain_L, pbatch, segment_slots,
               exact_cull, drain_xc):
    """Render one tile-contiguous chunk of rays with the dense tile
    kernel: flat (one call), in occupancy bands (one call per band), or
    in list segments (tp and rgba: one call per segment, resuming through
    the init carry), then the exact drain.  Returns the chunk's (T*64, 8)
    state and its counters."""
    T = rays_o.shape[0] // 64
    dev = rays_o.device
    dt = SQRT3 / max_samples
    align = pbatch if kernel == "tp" else 1
    fe = _chunk_frontend(brick_lo, brick_hi, rays_o, rays_du, cfg=cfg, L=L,
                         max_samples=max_samples, macro_tiles=macro_tiles,
                         macro_L=macro_L, exact_cull=exact_cull, align=align)
    pool_blk, meta, nvalid = fe["pool_blk"], fe["meta"], fe["nvalid"]
    Lp, L_orig = frontend_caps(L, macro_tiles, macro_L, exact_cull, align,
                               int(brick_lo.shape[0]))
    field = _field(kernel, pbatch, bcfg.block)
    tau_max = float(-np.log(T_threshold))
    fkw = dict(S=window_span(max_samples, bcfg.block, bcfg.voxel_res,
                             cfg.scale), dt=dt, tau_max=tau_max)
    fargs = (fe["rays8"], fe["sh"], pool3, *rgb_mlp)
    # the carry kernels resume from `out`; K3/K4 start listed tiles at zero
    into = (lambda o: dict(init=o, out=o)) if kernel in ("tp", "rgba") \
        else (lambda o: dict(out=o))
    out = torch.zeros((T * 64, 8), device=dev)
    cap = torch.full((T,), Lp, dtype=torch.int32, device=dev)
    if segment_slots > 0 and kernel in ("tp", "rgba") and not bands:
        # segmented lists with dead-tile elision: between segments, tiles
        # whose rays all saturated (or whose list ran out) get nslots=0.
        # Exact: the kernel's own live gate would add nothing for them.
        segL = max(align, (segment_slots // align) * align)
        while Lp % segL and segL > align:
            segL -= align
        if Lp % segL:
            raise ValueError(f"list capacity Lp={Lp} has no {align}-aligned "
                             f"divisor >= {align}; align exact_cull / L to "
                             "pbatch for kernel='tp'")
        pbT, mtT = pool_blk.view(T, Lp), meta.view(T, Lp, 8)
        tid_all = torch.arange(T, dtype=torch.int32, device=dev)
        dma_slots = torch.zeros((), dtype=torch.int64, device=dev)
        for si in range(Lp // segL):
            s0 = si * segL
            ns_rem = torch.clamp(nvalid - s0, 0, segL)
            live_t = ns_rem > 0
            if si > 0:
                live_t &= (out[:, 0].view(T, 64) < tau_max).any(1)
            ns_live = torch.where(live_t, ns_rem, 0)
            field(torch.where(live_t[:, None], pbT[:, s0:s0 + segL], 0)
                  .reshape(-1), mtT[:, s0:s0 + segL].reshape(-1, 8), *fargs,
                  tid=tid_all, lbase=tid_all * segL, nslots=ns_live,
                  Lcall=segL, **into(out), **fkw)
            dma_slots += ns_live.sum()
    elif not bands:
        field(pool_blk, meta, *fargs, nslots=nvalid, **into(out), **fkw)
        dma_slots = nvalid.sum()
    else:
        # band scheduling: tiles sorted by list occupancy, each band at
        # its own slot capacity; lists are depth-sorted, so a capacity
        # cut keeps the nearest bricks and the drain renders the rest.
        # Bands write disjoint tiles of one buffer (JAX selects per band).
        if sum(n for n, _ in bands) != T:
            raise ValueError(f"bands {bands} do not cover the chunk's {T} "
                             "tiles")
        order = torch.sort(-nvalid, stable=True).indices
        pos = 0
        for nb, lpb in bands:
            tid_b = order[pos:pos + nb]
            pos += nb
            lcb = min(lpb, Lp)
            if kernel == "tp":      # P consecutive list rows per step
                lcb = min(-(-lcb // pbatch) * pbatch, Lp)
            cap[tid_b] = lcb
            field(pool_blk, meta, *fargs, tid=tid_b,
                  nslots=torch.clamp(nvalid[tid_b], max=lcb), Lcall=lcb,
                  **into(out), **fkw)
        dma_slots = torch.minimum(nvalid, cap).sum()

    if exact_cull > 0:
        need = (fe["nhits"] > cap) | fe["macro_over"] | (fe["t_rel"] > L_orig)
        miss_sz = (torch.clamp_min(fe["nhits"] - cap, 0)
                   + torch.clamp_min(fe["t_rel"] - L_orig, 0))
    else:
        need = (fe["t_rel"] > cap) | fe["macro_over"]
        miss_sz = torch.clamp_min(fe["t_rel"] - cap, 0)
    if drain_tiles > 0:
        out, undrained, trunc, drain_slots = _drain_pass(
            out, fe, need, miss_sz, field, fargs, fkw, brick_lo, brick_hi,
            D=min(drain_tiles, T), drain_L=drain_L, drain_xc=drain_xc,
            exact_cull=exact_cull, align=align, dt=dt)
        dma_slots = dma_slots + drain_slots
    else:
        undrained = torch.where(need, miss_sz, 0).sum()
        trunc = need.sum()
    return out, dict(trunc_tiles=trunc,
                     pairs_rendered=out[:, 5].sum().to(torch.int64),
                     pairs_undrained=undrained, dma_slots=dma_slots)


@torch.no_grad()
def _mxu_frame(pool3, rgb_mlp, lo, hi, ro_ch, rd_ch, inv, *, W, H, Wp, Hp,
               exp_step_factor, **mxu_kw):
    """Per-chunk frame: each chunk of tiles runs its own front end, tile
    kernel calls and drain; counters add up over the chunks."""
    outs, counters = [], []
    for c in range(ro_ch.shape[0]):
        o, k = _mxu_tiles(pool3, rgb_mlp, lo, hi, ro_ch[c], rd_ch[c],
                          **mxu_kw)
        outs.append(o)
        counters.append(k)
    total = {k: sum(c[k].to(torch.int64) for c in counters)
             for k in counters[0]}
    return _finish(torch.cat(outs), total, inv, W=W, H=H, Wp=Wp, Hp=Hp,
                   exp_step_factor=exp_step_factor)


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
                             exact_cull=exact_cull, align=pbatch)
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
    fkw = dict(S=S, dt=dt, tau_max=tau_max)
    if drain_tiles > 0:
        out, undrained, trunc, drain_slots = _drain_pass(
            out, fe, need, miss_sz, _field("wl", pbatch, bcfg.block), fargs,
            fkw, lo, hi, D=min(drain_tiles, Tg), drain_L=drain_L,
            drain_xc=drain_xc, exact_cull=exact_cull, align=pbatch, dt=dt)
        dma_slots = dma_slots + drain_slots
    else:
        undrained = torch.where(need, miss_sz, 0).sum()
        trunc = need.sum()
    return _finish(out, dict(trunc_tiles=trunc,
                             pairs_rendered=out[:, 5].sum(),
                             pairs_undrained=undrained, dma_slots=dma_slots),
                   inv, W=W, H=H, Wp=Wp, Hp=Hp,
                   exp_step_factor=exp_step_factor)


KERNELS = ("n", "t", "tp", "wl", "rgba")


def render_brick_mxu(baked, cfg: NGPConfig, rays_o, rays_d, W, H, *,
                     bcfg: BakedConfig = BakedConfig(), L: int = 48,
                     max_samples: int = 512, T_threshold: float = 1e-2,
                     chunk_tiles: int = 512, macro_tiles: int = 8,
                     macro_L: int = 1024, geometry=None, kernel: str = "n",
                     bands=(), drain_tiles: int = 256, drain_L: int = 256,
                     pbatch: int = 4, segment_slots: int = 0,
                     exact_cull: int = 0, drain_xc: int = 0, wl_cap: int = 0,
                     exp_step_factor: float = 0.0, device="cuda"):
    """Full-frame brick renderer over W*H rays in image row-major order.

    Same arguments as the JAX entry, less `interpret`.  kernel: "n" (K3,
    the default), "t" (K4 on the transposed pool, built once and cached
    as baked["poolT"]), "tp" (K2, P=pbatch list slots per step), "rgba"
    (K5 on baked["poolRGBA"], see models/baked_rgba) or "wl" (the global
    worklist, K1).  bands: () = every tile at the full list capacity;
    "auto" = occupancy bands (1/8 of a chunk's tiles at the filtered L,
    1/8 at L/2, 1/4 at L/4, 1/2 at L/8); or explicit (n_tiles, Lp) pairs
    summing to the chunk's tiles.  segment_slots > 0 (tp, rgba, wl)
    renders lists in segments and skips saturated tiles between them,
    and turns bands off.  exact_cull > 0 filters the wide L-slot cull
    lists to true-hit bricks; drain_tiles/drain_L/drain_xc size the exact
    overflow drain; wl_cap bounds the worklist per segment (0 =
    max(T/2, 1024)).  `pairs_undrained == 0` certifies that every
    culled-in pair was rendered.  Returns a dict of rgb (H*W, 3),
    opacity, depth and the counters trunc_tiles, pairs_rendered,
    pairs_undrained, dma_slots."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r} not in {KERNELS}")
    if bcfg.feat_dim != 16:
        raise ValueError("kernel row layout is 8 corners x 16 features")
    if kernel in ("tp", "wl"):
        # list stride, band capacities and the drain's list length are
        # pbatch-aligned (those kernels read P consecutive list rows)
        if pbatch not in (1, 2, 4, 8, 16):
            raise ValueError(f"pbatch={pbatch} not in (1, 2, 4, 8, 16)")
        L = max(pbatch, (L // pbatch) * pbatch)
    if segment_slots > 0 or kernel == "wl":
        if kernel not in ("tp", "rgba", "wl"):
            raise ValueError(f"segment_slots needs an init-carry kernel "
                             f"(tp/rgba/wl), not {kernel!r}")
        bands = ()      # segmentation subsumes band scheduling's savings
    tile = 8
    lo, hi, _ = (geometry if geometry is not None
                 else brick_geometry(baked["block_map"], bcfg, cfg, device))
    lo, hi = lo.to(device), hi.to(device)
    vox = bcfg.block ** 3
    if kernel == "rgba":
        pool3 = baked["poolRGBA"].to(device)
        if tuple(pool3.shape[1:]) != (32, vox):
            raise ValueError(f"poolRGBA: shape {tuple(pool3.shape)}, "
                             f"expected (n_blocks, 32, {vox})")
    elif kernel == "t":
        # K4 reads the transposed (n_blocks, 128, vox) slabs; the copy is
        # made once and cached on the baked dict, as in JAX
        if "poolT" not in baked:
            baked["poolT"] = (baked["pool"].to(device).reshape(-1, vox, 128)
                              .transpose(1, 2).contiguous())
        pool3 = baked["poolT"].to(device)
    else:
        pool3 = baked["pool"].to(device).reshape(-1, vox, 128)
    rgb_mlp = [w.to(device).contiguous() for w in baked["rgb_mlp"]]
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
    if bands == "auto":
        # with exact_cull, bands schedule the filtered lists: capacities
        # derive from the compacted length, not the wide L
        eb = min(exact_cull, L) if exact_cull > 0 else L
        e, q = cpr // 8, cpr // 4
        bands = ((e, eb), (e, max(eb // 2, 8)), (q, max(eb // 4, 8)),
                 (cpr - e - e - q, max(eb // 8, 8)))
        bands = tuple((n, lp) for n, lp in bands if n > 0)
    bands = tuple(bands)
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
    if kernel in ("tp", "wl"):
        dL = max(pbatch, (dL // pbatch) * pbatch)
    kw = dict(cfg=cfg, bcfg=bcfg, L=L, max_samples=max_samples,
              T_threshold=T_threshold, macro_tiles=mt if mt > 1 else 0,
              macro_L=mL, drain_tiles=min(drain_tiles, cpr), drain_L=dL,
              pbatch=pbatch, segment_slots=segment_slots,
              exact_cull=exact_cull, drain_xc=drain_xc)
    frame_kw = dict(W=W, H=H, Wp=Wp, Hp=Hp, exp_step_factor=exp_step_factor)
    args = (pool3, rgb_mlp, lo, hi, ro_t.reshape(n_chunks, cpr * 64, 3),
            rd_t.reshape(n_chunks, cpr * 64, 3),
            torch.as_tensor(inv, dtype=torch.int64, device=device))
    if kernel == "wl":
        return _wl_frame(*args, **frame_kw, **kw, wl_cap=wl_cap)
    return _mxu_frame(*args, **frame_kw, **kw, kernel=kernel, bands=bands)
