"""Ray rendering (port of google_nerf_tpu/models/rendering.py): the
training forward pass and the round-based test renderer.

  * render_train: ray/AABB clip, the march (block, block2, seg or the
    dense lattice), budget packing, the field on the packed samples, the
    stream or padded composite, the incomplete-ray modes and the
    background;
  * render_test: rounds of (march_rays_test_round, the field,
    composite_rays_test_round) over a chunk until no ray is alive or
    max_rounds ran.  Where JAX runs the rounds as a lax.while_loop with
    its condition on the device, the port reads "any ray alive" on the
    host once a round.
"""
from __future__ import annotations

import torch

from google_nerf_tpu_torch.models.ngp import NGPConfig, ngp_apply
from google_nerf_tpu_torch.ops.compaction import pack, plan_packing, unpack
from google_nerf_tpu_torch.ops.composite import (composite_rays_test_round,
                                                 composite_rays_train)
from google_nerf_tpu_torch.ops.march_block import (block2_group,
                                                   block_group as
                                                   auto_block_group,
                                                   march_rays_train_block,
                                                   march_rays_train_block2)
from google_nerf_tpu_torch.ops.march_seg import march_rays_train_seg
from google_nerf_tpu_torch.ops.marching import (march_rays_test_round,
                                                march_rays_train)
from google_nerf_tpu_torch.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops.stream_composite import composite_stream_train
from google_nerf_tpu_torch.utils.logging import span

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.05


def _background(exp_step_factor: float):
    # synthetic scenes composite onto white, unbounded ones onto black
    return 1.0 if exp_step_factor == 0.0 else 0.0


def _clip(cfg: NGPConfig, rays_o, rays_d):
    """Unit directions and the near-clamped AABB hits (R, 2)."""
    dev = rays_o.device
    rays_du = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    hits = ray_aabb_intersect(rays_o, rays_du, torch.zeros(3, device=dev),
                              torch.full((3,), cfg.scale, device=dev))
    return rays_du, clamp_near(hits, NEAR_DISTANCE)


def render_train(params, cfg: NGPConfig, occ_grid, rays_o, rays_d, *,
                 noise, exp_step_factor: float = 0.0,
                 T_threshold: float = 1e-4, k_samples: int = 128,
                 max_samples: int = MAX_SAMPLES, samples_budget: int = 0,
                 occ_u8=None, march: str = "seg", seg: int = 8,
                 n_keep: int = 32, sup: int = 0, n_keep_sup: int = 12,
                 block_group: int = 0, n_keep_groups: int = 0,
                 bg_color=None, exclude_incomplete: str = "none",
                 incomplete_floor: float = 0.5, backfill_rgb=None,
                 backfill_enable: bool = True, stream: bool = True):
    """rays_o/rays_d: (R, 3), rays_d need not be unit; noise (R,) in
    [0, 1): the march's start jitter (JAX draws it from its key).

    The march: block2 with occ_u8 (pack_occupancy_block2's dict) and
    march="block2"; the one-phase block marcher with occ_u8
    (pack_occupancy_blocks' rows) and march="block", in groups of
    block_group candidates (0: the largest that one block row covers);
    the segment marcher with occ_u8 (pack_occupancy_u8's word grid)
    otherwise; the dense lattice on occ_grid where occ_u8 is
    None or the step is not constant.

    Returns dict: rgb (R, 3), opacity, depth, depth_sq (R,),
    total_samples, valid (R, K) and ray_mask (R,)."""
    constant = exp_step_factor == 0.0
    if exclude_incomplete not in ("none", "hard", "floor", "backfill"):
        raise ValueError(f"exclude_incomplete={exclude_incomplete!r}")
    R = rays_o.shape[0]
    with span("ngp.march"):
        rays_du, hits = _clip(cfg, rays_o, rays_d)
        if occ_u8 is not None and constant and march == "block2":
            # train keeps every supergroup (phase A's truncation flag has
            # false positives that would poison backfill supervision)
            g = block2_group(max_samples, cfg.scale, cfg.grid_size)
            m = march_rays_train_block2(
                rays_o, rays_du, hits, occ_u8, scale=cfg.scale,
                grid_size=cfg.grid_size, max_samples=max_samples,
                k_samples=k_samples, noise=noise,
                n_keep_super=max(1, max_samples // (g * 8)),
                n_keep_groups=n_keep_groups or max(1, (n_keep * seg) // g))
        elif occ_u8 is not None and constant and march == "block":
            # the default window budget is the seg marcher's reach (n_keep
            # segments of seg candidates), not k_samples // g: a smaller one
            # truncates content rays so often that training collapses (JAX's
            # record: mask_frac 0.6)
            g = block_group or auto_block_group(max_samples, cfg.scale,
                                                cfg.grid_size)
            m = march_rays_train_block(
                rays_o, rays_du, hits, occ_u8, scale=cfg.scale,
                grid_size=cfg.grid_size, max_samples=max_samples,
                k_samples=k_samples, noise=noise, group=g,
                n_keep_groups=n_keep_groups or max(1, (n_keep * seg) // g))
        elif occ_u8 is not None and constant:
            m = march_rays_train_seg(
                rays_o, rays_du, hits, occ_u8, cascades=cfg.cascades,
                scale=cfg.scale, grid_size=cfg.grid_size,
                max_samples=max_samples, k_samples=k_samples, noise=noise,
                seg=seg, n_keep=n_keep, sup=sup, n_keep_sup=n_keep_sup)
        else:
            m = march_rays_train(
                rays_o, rays_du, hits, occ_grid, cascades=cfg.cascades,
                scale=cfg.scale, exp_step_factor=exp_step_factor,
                grid_size=cfg.grid_size, max_samples=max_samples,
                k_samples=k_samples, noise=noise)
    K = m["ts"].shape[1]
    ray_mask = torch.ones((R,), dtype=torch.bool, device=rays_o.device)
    packed = bool(samples_budget) and samples_budget < R * K
    if packed:
        # the field runs only on (up to budget) real samples, ray-major,
        # so a ray whose samples did not all fit is masked out of the loss
        with span("ngp.pack"):
            plan = plan_packing(m["valid"], samples_budget,
                                sample_major=False)
            keep2d = plan.keep.reshape(R, K)
            ray_mask = ~(m["valid"] & ~keep2d).any(-1)
            feat = torch.cat([m["xyzs"].reshape(-1, 3),
                              m["dirs"].reshape(-1, 3),
                              m["deltas"].reshape(-1, 1),
                              m["ts"].reshape(-1, 1)], 1)
            fp = pack(feat, plan)
        sigmas, rgbs = ngp_apply(params, cfg, fp[:, :3], fp[:, 3:6])
    else:
        sigmas, rgbs = ngp_apply(params, cfg, m["xyzs"].reshape(-1, 3),
                                 m["dirs"].reshape(-1, 3))
    with span("ngp.composite"):
        if packed and stream:
            out = composite_stream_train(plan, sigmas, rgbs, fp[:, 6],
                                         fp[:, 7], R, K, T_threshold)
        elif packed:
            out = composite_rays_train(
                unpack(sigmas, plan).reshape(R, K),
                unpack(rgbs, plan).reshape(R, K, 3), m["deltas"], m["ts"],
                m["valid"], T_threshold)
        else:
            out = composite_rays_train(sigmas.reshape(R, K),
                                       rgbs.reshape(R, K, 3), m["deltas"],
                                       m["ts"], m["valid"], T_threshold)
        unconverged = out["opacity"] < 1.0 - T_threshold
        if exclude_incomplete == "backfill":
            # a truncated ray whose transmittance never converged
            # composites its residual transmittance onto the ground-truth
            # pixel instead of the background (no bias toward false
            # content, no supervision dropped); off during grid warmup,
            # when every ray truncates
            fill = m["truncated"] & unconverged & backfill_enable
            if backfill_rgb is not None:
                bgb = (torch.broadcast_to(bg_color, backfill_rgb.shape)
                       if bg_color is not None else
                       torch.full_like(backfill_rgb,
                                       _background(exp_step_factor)))
                bg_color = torch.where(fill[:, None], backfill_rgb, bgb)
        elif exclude_incomplete != "none":
            # a truncated, unconverged ray is left out of the loss; "floor"
            # does so only while that keeps incomplete_floor of the rays the
            # budget kept (decided on the device)
            surv = ray_mask & ~(m["truncated"] & unconverged)
            if exclude_incomplete == "hard":
                ray_mask = surv
            else:
                frac = surv.sum() / torch.clamp_min(ray_mask.sum(), 1)
                ray_mask = torch.where(frac >= incomplete_floor, surv,
                                       ray_mask)
        bg = _background(exp_step_factor) if bg_color is None else bg_color
        out["rgb"] = out["rgb"] + bg * (1.0 - out["opacity"][:, None])
    out["total_samples"] = m["total_samples"]
    out["valid"] = m["valid"]
    out["ray_mask"] = ray_mask
    return out


def _render_test_chunk(params, cfg: NGPConfig, occ_grid, rays_o, rays_d, *,
                       exp_step_factor: float, T_threshold: float,
                       n_cand: int, k_samples: int, max_rounds: int,
                       max_samples: int = MAX_SAMPLES):
    R = rays_o.shape[0]
    dev = rays_o.device
    rays_du, hits = _clip(cfg, rays_o, rays_d)
    t2 = hits[:, 1]
    t_cur = torch.clamp_min(hits[:, 0], 0.0)
    T = torch.ones(R, device=dev)
    alive = hits[:, 0] >= 0
    opacity, depth = torch.zeros(R, device=dev), torch.zeros(R, device=dev)
    rgb = torch.zeros((R, 3), device=dev)
    rounds = 0
    while rounds < max_rounds and bool(alive.any()):
        m = march_rays_test_round(
            rays_o, rays_du, t_cur, t2, alive, occ_grid,
            cascades=cfg.cascades, scale=cfg.scale,
            exp_step_factor=exp_step_factor, grid_size=cfg.grid_size,
            max_samples=max_samples, n_cand=n_cand, k_samples=k_samples)
        sig, col = ngp_apply(params, cfg, m["xyzs"].reshape(-1, 3),
                             m["dirs"].reshape(-1, 3))
        T, opacity, depth, rgb = composite_rays_test_round(
            sig.reshape(R, k_samples), col.reshape(R, k_samples, 3),
            m["deltas"], m["ts"], m["valid"], T, opacity, depth, rgb,
            T_threshold)
        t_cur = m["t_next"]
        alive = alive & (T > T_threshold) & (t_cur < t2)
        rounds += 1
    rgb = rgb + _background(exp_step_factor) * (1.0 - opacity[:, None])
    return dict(rgb=rgb, opacity=opacity, depth=depth)


@torch.no_grad()
def render_test(params, cfg: NGPConfig, occ_grid, rays_o, rays_d, *,
                exp_step_factor: float = 0.0, T_threshold: float = 1e-4,
                chunk: int = 65536, n_cand: int = 128, k_samples: int = 32,
                max_samples: int = MAX_SAMPLES):
    """Full test-time render in chunks of rays.  Each round consumes at
    least k_samples candidates of a live ray (n_cand of an empty
    window), so max_rounds = max_samples // k_samples + max_samples //
    n_cand + 4 bounds the reference's 1024-step march.  A chunk holds at
    most the ray count; pad rays start at the origin with direction (1,
    1, 1), as JAX pads them, and each ray's result is its own."""
    R = rays_o.shape[0]
    dev = rays_o.device
    chunk = min(chunk, max(R, 1))
    max_rounds = max_samples // k_samples + max_samples // n_cand + 4
    pad = (-R) % chunk
    ro = (torch.cat([rays_o, torch.zeros((pad, 3), device=dev)])
          if pad else rays_o)
    rd = (torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
          if pad else rays_d)
    outs = [_render_test_chunk(
        params, cfg, occ_grid, ro[i:i + chunk], rd[i:i + chunk],
        exp_step_factor=exp_step_factor, T_threshold=T_threshold,
        n_cand=n_cand, k_samples=k_samples, max_rounds=max_rounds,
        max_samples=max_samples) for i in range(0, R + pad, chunk)]
    return {k: torch.cat([o[k] for o in outs])[:R] for k in outs[0]}
