"""Training-time render (port of render_train in
google_nerf_tpu/models/rendering.py): ray/AABB clip, the block2 march,
budget packing, the field on the packed samples, the stream composite,
the backfill of truncated rays and the background.

Only the flagship path is ported: `march="block2"` with a constant step
and `stream=True`.  The other marchers are ROADMAP item 14 (seg, dense)
and 15 (block); the padded (R, K) composite after unpack is item 15;
`render_test` is item 15.
"""
from __future__ import annotations

import torch

from google_nerf_tpu_torch.core.rays import norm3
from google_nerf_tpu_torch.models.ngp import NGPConfig, ngp_apply
from google_nerf_tpu_torch.ops.compaction import pack, plan_packing
from google_nerf_tpu_torch.ops.march_block import (block2_group,
                                                   march_rays_train_block2)
from google_nerf_tpu_torch.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops.stream_composite import composite_stream_train

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.05


def _background(exp_step_factor: float):
    # synthetic scenes composite onto white, unbounded ones onto black
    return 1.0 if exp_step_factor == 0.0 else 0.0


def render_train(params, cfg: NGPConfig, occ_grid, rays_o, rays_d, *,
                 noise, exp_step_factor: float = 0.0,
                 T_threshold: float = 1e-4, k_samples: int = 128,
                 max_samples: int = MAX_SAMPLES, samples_budget: int = 0,
                 occ_u8=None, march: str = "block2", seg: int = 8,
                 n_keep: int = 32, n_keep_groups: int = 0, bg_color=None,
                 exclude_incomplete: str = "none", backfill_rgb=None,
                 backfill_enable: bool = True, stream: bool = True):
    """rays_o/rays_d: (R, 3), rays_d need not be unit; noise (R,) in
    [0, 1): the march's start jitter (JAX draws it from its key).

    Returns dict: rgb (R, 3), opacity, depth, depth_sq (R,),
    total_samples, valid (R, K) and ray_mask (R,)."""
    if march != "block2" or occ_u8 is None or exp_step_factor != 0.0:
        raise NotImplementedError(
            f"march={march!r}, exp_step_factor={exp_step_factor}: only the "
            "constant-step block2 march is ported; the seg and dense "
            "marchers are ROADMAP item 14, the block marcher item 15")
    if exclude_incomplete not in ("none", "backfill"):
        raise NotImplementedError(
            f"exclude_incomplete={exclude_incomplete!r}: only 'none' and "
            "'backfill' are ported (ROADMAP item 15 brings 'hard'/'floor')")
    R = rays_o.shape[0]
    dev = rays_o.device
    rays_du = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    hits = ray_aabb_intersect(rays_o, rays_du, torch.zeros(3, device=dev),
                              torch.full((3,), cfg.scale, device=dev))
    hits = clamp_near(hits, NEAR_DISTANCE)
    # train keeps every supergroup (phase A's truncation flag has false
    # positives that would poison backfill supervision)
    g = block2_group(max_samples, cfg.scale, cfg.grid_size)
    m = march_rays_train_block2(
        rays_o, rays_du, hits, occ_u8, scale=cfg.scale,
        grid_size=cfg.grid_size, max_samples=max_samples,
        k_samples=k_samples, noise=noise,
        n_keep_super=max(1, max_samples // (g * 8)),
        n_keep_groups=n_keep_groups or max(1, (n_keep * seg) // g))
    K = m["ts"].shape[1]
    if not (samples_budget and samples_budget < R * K and stream):
        raise NotImplementedError(
            "only the budget-packed stream composite is ported "
            f"(samples_budget={samples_budget}, stream={stream}); the padded "
            "(R, K) composite paths are ROADMAP item 15")
    # the field runs only on (up to budget) real samples, ray-major, so a
    # ray whose samples did not all fit is masked out of the loss
    plan = plan_packing(m["valid"], samples_budget, sample_major=False)
    keep2d = plan.keep.reshape(R, K)
    ray_mask = ~(m["valid"] & ~keep2d).any(-1)
    feat = torch.cat([m["xyzs"].reshape(-1, 3), m["dirs"].reshape(-1, 3),
                      m["deltas"].reshape(-1, 1), m["ts"].reshape(-1, 1)], 1)
    fp = pack(feat, plan)
    sig_p, rgb_p = ngp_apply(params, cfg, fp[:, :3], fp[:, 3:6])
    out = composite_stream_train(plan, sig_p, rgb_p, fp[:, 6], fp[:, 7], R, K,
                                 T_threshold)
    if exclude_incomplete == "backfill":
        # a truncated ray whose transmittance never converged composites
        # its residual transmittance onto the ground-truth pixel instead of
        # the background (no bias toward false content, no supervision
        # dropped); off during grid warmup, when every ray truncates
        fill = m["truncated"] & (out["opacity"] < 1.0 - T_threshold)
        fill = fill & backfill_enable
        if backfill_rgb is not None:
            bgb = (torch.broadcast_to(bg_color, backfill_rgb.shape)
                   if bg_color is not None else
                   torch.full_like(backfill_rgb, _background(exp_step_factor)))
            bg_color = torch.where(fill[:, None], backfill_rgb, bgb)
    bg = _background(exp_step_factor) if bg_color is None else bg_color
    out["rgb"] = out["rgb"] + bg * (1.0 - out["opacity"][:, None])
    out["total_samples"] = m["total_samples"]
    out["valid"] = m["valid"]
    out["ray_mask"] = ray_mask
    return out
