"""The two-phase block marcher for training (port of block2 in
google_nerf_tpu/ops/march_block.py; `super_any_live` and the one-phase
`march_rays_train_block` are ROADMAP items 14 and 15).

Candidates lie on JAX's constant-step lattice t_i = t0 + i*dt, dt =
sqrt(3)/max_samples, computed in the same order, so sample positions
equal the dense marcher's whenever nothing is truncated.  Phase A tests
supergroups of sg*g candidates against a small liveness table; phase B
takes the exact bit of every candidate of a kept supergroup from one
64-byte block row per group of g (pack_occupancy_blocks4), then keeps
the first n_keep_groups live groups per ray.  Constant-step
single-cascade scenes only.
"""
from __future__ import annotations

import math

import torch

from google_nerf_tpu_torch.ops.march_seg import _cell_index_single, _first_k

SQRT3 = 3.0 ** 0.5
BLOCK = 8
WORDS = BLOCK ** 3 // 32


def block2_group(max_samples: int, scale: float, grid_size: int,
                 stride: int = 4, cap: int = 32) -> int:
    """Largest power-of-2 divisor g of max_samples such that g consecutive
    candidates span <= BLOCK - stride - 1 cells per axis, so the 8^3 block
    row anchored at the stride-quantized floor of the group's min cell
    holds every candidate's bit."""
    dt = SQRT3 / max_samples
    bound = min(0.5, scale)
    cells_per_step = dt * grid_size / (2.0 * bound)
    g = 1
    while (2 * g <= cap and max_samples % (2 * g) == 0
           and (2 * g - 1) * cells_per_step < BLOCK - stride):
        g *= 2
    return g


def super_window(max_samples: int, scale: float, grid_size: int,
                 sg: int = 8, stride: int = 4, sup_stride: int = 8) -> int:
    """Forward-window size (cells) the super-liveness table must cover for
    supergroups of sg fine groups: supergroup cell-span + anchor slack."""
    dt = SQRT3 / max_samples
    bound = min(0.5, scale)
    cells_per_step = dt * grid_size / (2.0 * bound)
    gs = block2_group(max_samples, scale, grid_size, stride) * sg
    return int(math.ceil((gs - 1) * cells_per_step)) + 1 + sup_stride


def pack_occupancy_block2(occ, *, max_samples: int, scale: float,
                          sg: int = 8, stride: int = 4,
                          sup_stride: int = 8):
    """Both tables the two-phase marcher needs, as a dict."""
    from google_nerf_tpu_torch.ops.grid import (pack_occupancy_blocks4,
                                                pack_super_liveness)
    G = occ.shape[1]
    return dict(
        blocks4=pack_occupancy_blocks4(occ, stride),
        super=pack_super_liveness(
            occ, super_window(max_samples, scale, G, sg, stride,
                              sup_stride), sup_stride))


def _raster(a, n: int):
    return (a[..., 0] * n + a[..., 1]) * n + a[..., 2]


def _phase_a_lives(sup_tab, o, d, t0, t2, hit, *, scale, grid_size,
                   dt, gs, qs, sup_stride):
    """Supergroup liveness from endpoint cells: (R, qs) bool + (R, qs) tsa."""
    Gq = grid_size // sup_stride
    s = torch.arange(qs, dtype=torch.float32, device=o.device)
    tsa = t0[:, None] + s[None, :] * (gs * dt)               # (R, qs)
    tsb = tsa + (gs - 1) * dt
    na = _cell_index_single(o[:, None, :] + tsa[..., None] * d[:, None, :],
                            scale, grid_size)
    nb = _cell_index_single(o[:, None, :] + tsb[..., None] * d[:, None, :],
                            scale, grid_size)
    a = torch.clamp(torch.div(torch.minimum(na, nb), sup_stride,
                              rounding_mode="floor"), 0, Gq - 1)
    lives = sup_tab[_raster(a, Gq).long()] > 0               # (R, qs)
    return lives & (tsa < t2[:, None]) & hit[:, None], tsa


def march_rays_train_block2(rays_o, rays_d, hits_t, occ2, *, scale: float,
                            grid_size: int, max_samples: int,
                            k_samples: int, noise, sg: int = 8,
                            n_keep_super: int = 4, n_keep_groups: int = 0,
                            stride: int = 4, sup_stride: int = 8):
    """Two-phase block marcher -> padded (R, K) samples: xyzs, dirs
    (R, K, 3), deltas, ts (R, K), valid (R, K) bool, truncated (R,),
    t_resume (R,) and total_samples.  occ2: pack_occupancy_block2's dict
    (same sg/stride/sup_stride); noise (R,) in [0, 1).  Samples carry no
    gradient through t: xyzs = rays_o + ts * rays_d only."""
    blocks4, sup_tab = occ2["blocks4"], occ2["super"]
    R = rays_o.shape[0]
    dev = rays_o.device
    dt = SQRT3 / max_samples
    g = block2_group(max_samples, scale, grid_size, stride)
    gs = g * sg
    qs = max_samples // gs
    nks = min(n_keep_super, qs)
    nk = min(n_keep_groups or max(1, -(-k_samples // g)), nks * sg)
    k_samples = min(k_samples, nk * g)
    Gs = grid_size // stride

    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    t0 = torch.clamp_min(t1, 0.0) + dt * noise
    o, d = rays_o.detach(), rays_d.detach()
    inf = torch.full((R,), math.inf, device=dev)

    # ---- phase A: supergroup liveness (skipped when every super is kept:
    # its bounding-box test would flag false truncations)
    if nks >= qs:
        pick_s = torch.arange(qs, dtype=torch.int64,
                              device=dev).expand(R, qs)
        svalid = torch.ones((R, qs), dtype=torch.bool, device=dev)
        trunc_sup = torch.zeros((R,), dtype=torch.bool, device=dev)
        t_resume = inf
    else:
        lives, _ = _phase_a_lives(sup_tab, o, d, t0, t2, hit, scale=scale,
                                  grid_size=grid_size, dt=dt, gs=gs, qs=qs,
                                  sup_stride=sup_stride)
        pick_s, svalid = _first_k(lives, nks)                # (R, nks)
        trunc_sup = lives.sum(-1) > nks
        last = torch.where(svalid, pick_s, -1).amax(-1).to(torch.float32)
        t_resume = torch.where(trunc_sup, t0 + (last + 1.0) * gs * dt, inf)

    # ---- phase B: exact bits inside kept supergroups
    j = torch.arange(gs, dtype=torch.float32, device=dev)
    ts = (t0[:, None, None] + pick_s[..., None].to(torch.float32)
          * (gs * dt) + j * dt).reshape(R, nks * gs)         # ascending t
    xyz = o[:, None, :] + ts[..., None] * d[:, None, :]
    n = _cell_index_single(xyz, scale, grid_size)
    ng = n.reshape(R, nks * sg, g, 3)
    anchor = torch.clamp(torch.div(ng.amin(-2), stride,
                                   rounding_mode="floor"), 0, Gs - 1)
    rows = blocks4[_raster(anchor, Gs).reshape(-1).long()].reshape(
        R, nks * sg, WORDS)
    off = ng - (anchor * stride)[..., None, :]               # in {0..7}
    bitpos = (off[..., 0] * BLOCK + off[..., 1]) * BLOCK + off[..., 2]
    word = torch.gather(rows, -1, (bitpos >> 5).long())      # (R, nks*sg, g)
    occ_bit = ((word >> (bitpos & 31)) & 1) > 0
    cand_ok = (occ_bit.reshape(R, nks, gs)
               & svalid[..., None]).reshape(R, nks * gs)
    cand_ok = cand_ok & (ts < t2[:, None]) & hit[:, None]

    # ---- group-liveness compaction: the first nk live groups per ray
    grp_ok = cand_ok.reshape(R, nks * sg, g)
    live = grp_ok.any(-1)
    pick, gvalid = _first_k(live, nk)                        # (R, nk)
    trunc_grp = live.sum(-1) > nk
    ts_grp0 = ts.reshape(R, nks * sg, g)[..., 0]             # group start t
    last_t = torch.where(gvalid, torch.gather(ts_grp0, 1, pick),
                         0.0).amax(-1)
    t_resume = torch.minimum(t_resume, torch.where(trunc_grp,
                                                   last_t + g * dt, inf))
    truncated = trunc_sup | trunc_grp
    pick3 = pick[..., None].expand(R, nk, g)
    sel = torch.gather(grp_ok, 1, pick3)                     # (R, nk, g)
    ts_sel = torch.gather(ts.reshape(R, nks * sg, g), 1, pick3)
    cand = (sel & gvalid[..., None]).reshape(R, nk * g)
    ts_flat = ts_sel.reshape(R, nk * g)

    if k_samples >= nk * g:
        valid = cand
        ts_out = torch.where(valid, ts_flat, 0.0)
    else:
        idx, valid = _first_k(cand, k_samples)
        trunc2 = cand.sum(-1) > k_samples
        ts_out = torch.where(valid, torch.gather(ts_flat, 1, idx), 0.0)
        t_resume = torch.minimum(t_resume, torch.where(
            trunc2, torch.where(valid, ts_out, 0.0).amax(-1) + dt, inf))
        truncated = truncated | trunc2
    deltas = torch.where(valid, dt, 0.0)
    xyzs = rays_o[:, None, :] + ts_out[..., None] * rays_d[:, None, :]
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    return dict(xyzs=xyzs, dirs=dirs, deltas=deltas, ts=ts_out, valid=valid,
                truncated=truncated, t_resume=t_resume,
                total_samples=valid.sum())
