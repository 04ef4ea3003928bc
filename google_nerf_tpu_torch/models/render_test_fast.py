"""Fast test-time renderer: alive-ray bucket compaction (port of
google_nerf_tpu/models/render_test_fast.py).

Each iteration takes the first `bucket` alive rays of the chunk (JAX's
top_k on -index), marches one window of n_segs * seg candidates for
them through the dilated segment words (ops/march_seg.py), evaluates
the field on the budget-packed real samples only, composites the window
front to back, and writes the bucket's rows back.

Where JAX runs the iterations as a lax.while_loop with its condition on
the device, the port reads "any ray alive" on the host once an
iteration, bounded by max_iters.  The bucket's slots beyond the alive
count hold dead rays; they write their own rows back unchanged (a plain
index_copy_ of distinct indices), so the result does not depend on how
topk orders those ties.  The per-ray state rides one (R, 8) tensor
[rgb | depth | opacity | T | t_cur | alive].
"""
from __future__ import annotations

import torch

from google_nerf_tpu_torch.models.ngp import NGPConfig, ngp_apply
from google_nerf_tpu_torch.ops.compaction import pack, plan_packing, unpack
from google_nerf_tpu_torch.ops.march_seg import (_first_k, _occ_bits_lookup,
                                                 _occ_block_lookup,
                                                 _seg_live_block,
                                                 _word_group)
from google_nerf_tpu_torch.ops.ray_aabb import clamp_near, ray_aabb_intersect

SQRT3 = 3.0 ** 0.5
NEAR_DISTANCE = 0.05


def _march_window(rays_o, rays_d, t_cur, t2, occ_u8, *, cascades, scale,
                  grid_size, max_samples, seg, n_segs, n_keep, k):
    """March one window of n_segs * seg candidates from per-ray t_cur.

    Returns ts (B, k), valid (B, k), t_next (B,) and dt: t_next is past
    the window if it held <= k hits, else just past the k-th hit, or the
    start of the first live segment beyond the n_keep kept ones."""
    B = rays_o.shape[0]
    dev = rays_o.device
    dt = SQRT3 / max_samples
    ar = torch.arange(n_segs, dtype=torch.float32, device=dev)
    seg_t0 = t_cur[:, None] + (ar * seg)[None, :] * dt
    if cascades == 1 and _word_group(seg, dt, scale, grid_size) == seg:
        live = _seg_live_block(occ_u8, rays_o, rays_d, seg_t0, seg, dt,
                               scale, grid_size)
    else:
        ts_mid = t_cur[:, None] + (ar * seg + (seg - 1) / 2)[None, :] * dt
        xyz_mid = rays_o[:, None, :] + ts_mid[..., None] * rays_d[:, None, :]
        live = _occ_bits_lookup(occ_u8, xyz_mid, torch.full_like(ts_mid, dt),
                                cascades, scale, grid_size, bit=1)
    live = live & (seg_t0 < t2[:, None])

    nk1 = min(n_keep + 1, n_segs)          # +1: detect dropped live segments
    sidx1, svalid1 = _first_k(live, nk1)
    sidx, svalid = sidx1[:, :n_keep], svalid1[:, :n_keep]
    # a live segment beyond the n_keep kept ones: the window resumes at
    # its start instead of skipping to the window's end
    if nk1 > n_keep:
        overflow = svalid1[:, n_keep]
        overflow_t = t_cur + sidx1[:, n_keep].to(torch.float32) * seg * dt
    else:
        overflow = torch.zeros(B, dtype=torch.bool, device=dev)
        overflow_t = torch.zeros(B, device=dev)

    off = torch.arange(seg, dtype=torch.float32, device=dev)
    ts_c = t_cur[:, None, None] + (sidx.to(torch.float32)[..., None] * seg
                                   + off) * dt                # (B, nk, seg)
    xyz_c = rays_o[:, None, None, :] \
        + ts_c[..., None] * rays_d[:, None, None, :]
    g = _word_group(seg, dt, scale, grid_size) if cascades == 1 else 1
    if g > 1:
        occ = _occ_block_lookup(occ_u8, xyz_c, scale, grid_size, g)
    else:
        occ = _occ_bits_lookup(occ_u8, xyz_c, torch.full_like(ts_c, dt),
                               cascades, scale, grid_size, bit=0)
    ok = (occ & (ts_c < t2[:, None, None]) & svalid[..., None]).reshape(B, -1)
    idx2, valid = _first_k(ok, k)
    ts = torch.where(valid, torch.gather(ts_c.reshape(B, -1), 1, idx2), 0.0)

    count = ok.sum(-1)
    window_end = t_cur + (n_segs * seg) * dt
    last_t = torch.where(valid, ts, 0.0).amax(-1)
    t_next = torch.where(count > k, last_t + dt,
                         torch.where(overflow, overflow_t, window_end))
    return ts, valid, t_next, dt


def _render_chunk_fast(params, cfg: NGPConfig, occ_u8, rays_o, rays_d, *,
                       exp_step_factor: float, T_threshold: float,
                       bucket: int, k: int, seg: int, n_segs: int,
                       n_keep: int, max_samples: int, max_iters: int,
                       sample_budget: int, apply_fn=None):
    field = apply_fn or ngp_apply
    R = rays_o.shape[0]
    dev = rays_o.device
    rays_du = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    hits = clamp_near(ray_aabb_intersect(
        rays_o, rays_du, torch.zeros(3, device=dev),
        torch.full((3,), cfg.scale, device=dev)), NEAR_DISTANCE)
    t2 = torch.where(hits[:, 1] > 0, hits[:, 1], 0.0)
    alive0 = (hits[:, 0] >= 0) & (hits[:, 1] > hits[:, 0])
    zeros = torch.zeros(R, device=dev)
    # [rgb | depth | opacity | T | t_cur | alive]
    state = torch.stack([zeros, zeros, zeros, zeros, zeros, zeros + 1.0,
                         torch.clamp_min(hits[:, 0], 0.0),
                         alive0.to(torch.float32)], 1)
    it = 0
    while it < max_iters and bool((state[:, 7] > 0.5).any()):
        ridx, is_real = _first_k(state[:, 7] > 0.5, bucket)
        st = state.index_select(0, ridx)
        o, d, tc = rays_o[ridx], rays_du[ridx], st[:, 6]
        tf = torch.where(is_real, t2[ridx], 0.0)
        ts, valid, t_next, dt = _march_window(
            o, d, tc, tf, occ_u8, cascades=cfg.cascades, scale=cfg.scale,
            grid_size=cfg.grid_size, max_samples=max_samples, seg=seg,
            n_segs=n_segs, n_keep=n_keep, k=k)
        valid = valid & is_real[:, None]

        xyzs = o[:, None, :] + ts[..., None] * d[:, None, :]
        dirs = d[:, None, :].expand(xyzs.shape)
        plan = plan_packing(valid, sample_budget, sample_major=False)
        sig_p, col_p = field(params, cfg, pack(xyzs.reshape(-1, 3), plan),
                             pack(dirs.reshape(-1, 3), plan))
        sig = unpack(sig_p, plan).reshape(bucket, k)
        col = unpack(col_p, plan).reshape(bucket, k, 3)
        # a ray whose samples the budget cut resumes where its kept
        # samples end; a starved ray retries from t_cur (never backward)
        keep2d = plan.keep.reshape(bucket, k)
        trunc = (valid & ~keep2d).any(-1)
        last_kept_t = torch.where(valid & keep2d, ts, 0.0).amax(-1)
        t_next = torch.maximum(torch.where(trunc, last_kept_t + dt, t_next),
                               tc)
        valid = valid & keep2d

        # front-to-back composite of the window's samples
        Tb = st[:, 5]
        alphas = torch.where(valid, 1.0 - torch.exp(-sig * dt), 0.0)
        trans = torch.cumprod(1.0 - alphas + 1e-10, -1)
        trans = torch.cat([torch.ones((bucket, 1), device=dev),
                           trans[:, :-1]], 1)
        w = alphas * trans * Tb[:, None]
        T_new = Tb * trans[:, -1] * (1.0 - alphas[:, -1])
        alive_new = (T_new > T_threshold) & (t_next < tf) & is_real
        new = torch.cat([st[:, 0:3] + (w[..., None] * col).sum(1),
                         (st[:, 3] + (w * ts).sum(-1))[:, None],
                         (st[:, 4] + w.sum(-1))[:, None], T_new[:, None],
                         t_next[:, None],
                         alive_new.to(torch.float32)[:, None]], 1)
        state.index_copy_(0, ridx, torch.where(is_real[:, None], new, st))
        it += 1
    bg = 1.0 if exp_step_factor == 0.0 else 0.0
    opacity = state[:, 4]
    return dict(rgb=state[:, 0:3] + bg * (1.0 - opacity[:, None]),
                opacity=opacity, depth=state[:, 3])


@torch.no_grad()
def render_test_fast(params, cfg: NGPConfig, occ_u8, rays_o, rays_d, *,
                     exp_step_factor: float = 0.0, T_threshold: float = 1e-2,
                     chunk: int = 262144, bucket: int = 32768, k: int = 32,
                     seg: int = 8, n_segs: int = 32, n_keep: int = 8,
                     max_samples: int = 1024, apply_fn=None):
    """Full-image fast renderer (bounded scenes; occ_u8 from
    grid.pack_occupancy_u8).  apply_fn(params, cfg, x, d) -> (sigmas,
    rgbs) replaces the live field (e.g. baked.make_baked_apply)."""
    R = rays_o.shape[0]
    dev = rays_o.device
    chunk = min(chunk, max(R, 1))          # tiny renders are not padded up
    bucket = min(bucket, chunk)
    # an iteration either retires a window of every served ray or uses up
    # the sample budget; JAX's bound on both, plus slack
    windows_per_ray = max_samples // (n_segs * seg) + 2
    sample_budget = max(bucket * k // 4, 1)
    max_iters = ((min(R, chunk) * windows_per_ray) // bucket
                 + (min(R, chunk) * max_samples) // sample_budget + 64)
    pad = (-R) % chunk
    ro = (torch.cat([rays_o, torch.zeros((pad, 3), device=dev)])
          if pad else rays_o)
    rd = (torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
          if pad else rays_d)
    outs = [_render_chunk_fast(
        params, cfg, occ_u8, ro[i:i + chunk], rd[i:i + chunk],
        exp_step_factor=exp_step_factor, T_threshold=T_threshold,
        bucket=bucket, k=k, seg=seg, n_segs=n_segs, n_keep=n_keep,
        max_samples=max_samples, max_iters=max_iters,
        sample_budget=sample_budget, apply_fn=apply_fn)
        for i in range(0, R + pad, chunk)]
    return {key: torch.cat([o[key] for o in outs])[:R] for key in outs[0]}
