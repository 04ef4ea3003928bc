"""One-shot test renderer (port of
google_nerf_tpu/models/render_test_oneshot.py): march every ray ONCE,
composite with a transmittance carry, then re-pass only the straggler
rays that had more content than one pass's capacity.

  main pass: every ray, k samples (segment, block or block2 march,
             then a dense row-wise or budget-packed field and
             composite); with `compact_main` there is no main pass: one
             phase-A super scan marks the rays that may hold content and
             only those enter the drain;
  stragglers: the alive rays of the whole image, at most chunk /
             straggler_div a pass, resumed where their march stopped:
             a fixed number of passes, or with `drain` until none is
             alive (at most `max_passes` trips).

Where JAX runs the drain as a `lax.while_loop` with its condition on the
device, the port reads "any ray alive" on the host once a trip.  A trip
takes the alive rays of lowest index (JAX's top_k on -index); the slots
beyond the alive count hold dead rays, which write back their own rows
unchanged, so the result does not depend on how topk orders those ties.
The per-ray state rides one (N, 8) tensor [rgb | opacity | depth | T |
t_cur | alive] and the constants one (N, 7) [ro | rdu | t2], as in JAX.
"""
from __future__ import annotations

import math

import torch

from google_nerf_tpu_torch.core.rays import norm3
from google_nerf_tpu_torch.models.ngp import NGPConfig, ngp_apply
from google_nerf_tpu_torch.ops.compaction import pack, plan_packing
from google_nerf_tpu_torch.ops.composite import _exclusive_cumsum
from google_nerf_tpu_torch.ops.march_block import (block2_group, block_group,
                                                   march_rays_train_block,
                                                   march_rays_train_block2,
                                                   super_any_live)
from google_nerf_tpu_torch.ops.march_seg import _first_k, march_rays_train_seg
from google_nerf_tpu_torch.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops.stream_composite import composite_stream_train
from google_nerf_tpu_torch.utils.logging import count, span

NEAR_DISTANCE = 0.05


def _march(cfg: NGPConfig, occ_u8, rays_o, rays_d, hits, *, k, n_keep, sup,
           n_keep_sup, max_samples, march, n_keep_super):
    noise = torch.zeros(rays_o.shape[0], device=rays_o.device)
    if march == "block2":
        g2 = block2_group(max_samples, cfg.scale, cfg.grid_size)
        nkg = max(1, (n_keep * 8) // g2)
        # n_keep_super 0: the group budget's supers, plus one of slack
        nks = n_keep_super or max(1, -(-nkg // 8) + 1)
        return march_rays_train_block2(
            rays_o, rays_d, hits, occ_u8, scale=cfg.scale,
            grid_size=cfg.grid_size, max_samples=max_samples, k_samples=k,
            noise=noise, n_keep_super=nks, n_keep_groups=nkg)
    if march == "block":
        # the window budget is the seg path's reach, n_keep segments of 8
        g = block_group(max_samples, cfg.scale, cfg.grid_size)
        return march_rays_train_block(
            rays_o, rays_d, hits, occ_u8, scale=cfg.scale,
            grid_size=cfg.grid_size, max_samples=max_samples, k_samples=k,
            noise=noise, n_keep_groups=max(1, (n_keep * 8) // g))
    return march_rays_train_seg(
        rays_o, rays_d, hits, occ_u8, cascades=cfg.cascades, scale=cfg.scale,
        grid_size=cfg.grid_size, max_samples=max_samples, k_samples=k,
        noise=noise, seg=8, n_keep=n_keep, sup=sup, n_keep_sup=n_keep_sup)


def _render_pass(params, cfg: NGPConfig, occ_u8, rays_o, rays_d, t_cur, t2,
                 T_in, *, T_threshold: float, k: int, n_keep: int, sup: int,
                 n_keep_sup: int, max_samples: int, budget: int,
                 apply_fn=None, march: str = "seg", n_keep_super: int = 0):
    """One march + composite pass from per-ray t_cur.  Returns this
    pass's accumulations (already scaled by T_in) and the new carry."""
    field = apply_fn or ngp_apply
    R = rays_o.shape[0]
    with span("ngp.march"):
        hits = torch.stack([torch.where(t_cur < t2, t_cur, -1.0), t2], 1)
        m = _march(cfg, occ_u8, rays_o, rays_d, hits, k=k, n_keep=n_keep,
                   sup=sup, n_keep_sup=n_keep_sup, max_samples=max_samples,
                   march=march, n_keep_super=n_keep_super)
    K = m["ts"].shape[1]
    if budget and budget < R * K:
        with span("ngp.pack"):
            plan = plan_packing(m["valid"], budget, sample_major=False)
            processed = ~(m["valid"] & ~plan.keep.reshape(R, K)).any(-1)
            xyz_p = pack(m["xyzs"].reshape(-1, 3), plan)
            dir_p = pack(m["dirs"].reshape(-1, 3), plan)
            dl_p = pack(m["deltas"].reshape(-1), plan)
            ts_p = pack(m["ts"].reshape(-1), plan)
        sig_p, rgb_p = field(params, cfg, xyz_p, dir_p)
        with span("ngp.composite"):
            out = composite_stream_train(plan, sig_p, rgb_p, dl_p, ts_p, R,
                                         K, T_threshold)
    else:
        # dense pass: the field on every padded slot, composited row-wise
        # (the exclusive sum in JAX's form)
        sig, rgb_s = field(params, cfg, m["xyzs"].reshape(-1, 3),
                           m["dirs"].reshape(-1, 3))
        with span("ngp.composite"):
            sig = sig.reshape(R, K)
            rgb_s = rgb_s.reshape(R, K, 3)
            sd = torch.clamp_max(
                torch.where(m["valid"], sig * m["deltas"], 0.0), 80.0)
            T_before = torch.exp(-_exclusive_cumsum(sd))
            alpha = 1.0 - torch.exp(-sd)
            include = m["valid"] & (T_before > T_threshold)
            w = torch.where(include, T_before * alpha, 0.0)
            out = dict(opacity=torch.clamp(w.sum(-1), 0.0, 1.0),
                       depth=(w * m["ts"]).sum(-1),
                       rgb=(w[..., None] * rgb_s).sum(-2),
                       tau=torch.where(include, sd, 0.0).sum(-1))
        processed = torch.ones((R,), dtype=torch.bool, device=rays_o.device)
    # budget-dropped rays contribute nothing and retry from where they were
    sc = torch.where(processed, T_in, 0.0)
    T_new = torch.where(processed, T_in * torch.exp(-out["tau"]), T_in)
    # resume at the marcher's earliest unexamined point: a truncated pass
    # can keep conservative segments with no exact sample
    t_next = torch.where(processed & m["truncated"],
                         torch.minimum(m["t_resume"], t2), t2)
    t_next = torch.where(processed, torch.maximum(t_next, t_cur), t_cur)
    alive = (T_new > T_threshold) & (t_next < t2) \
        & (m["truncated"] | ~processed)
    return dict(rgb=sc[:, None] * out["rgb"], opacity=sc * out["opacity"],
                depth=sc * out["depth"], T=T_new, t_next=t_next, alive=alive)


def _clip(cfg: NGPConfig, rays_o, rays_du):
    """AABB clip: (t2, t_cur) with t_cur = inf for rays that miss."""
    dev = rays_o.device
    hits = ray_aabb_intersect(rays_o, rays_du, torch.zeros(3, device=dev),
                              torch.full((3,), cfg.scale, device=dev))
    hits = clamp_near(hits, NEAR_DISTANCE)
    t2 = torch.where(hits[:, 1] > 0, hits[:, 1], 0.0)
    t_cur = torch.where(hits[:, 0] >= 0, torch.clamp_min(hits[:, 0], 0.0),
                        math.inf)
    return hits, t2, t_cur


def _straggler_pass(params, cfg, occ_u8, ro, rdu, t2, rgb, opacity, depth,
                    T, t_cur, alive, *, sr, budget, **kw):
    """One straggler pass: the first sr alive rays resume their march from
    t_cur and their results are written back (dead picks keep their
    rows)."""
    ridx, is_real = _first_k(alive, sr)
    q = _render_pass(params, cfg, occ_u8, ro[ridx], rdu[ridx],
                     torch.where(is_real, t_cur[ridx], math.inf),
                     torch.where(is_real, t2[ridx], 0.0),
                     torch.where(is_real, T[ridx], 0.0), budget=budget, **kw)

    def scat(full, new, add=True):
        cur = full[ridx]
        upd = cur + new if add else new
        keep = is_real.reshape((-1,) + (1,) * (upd.ndim - 1))
        return full.index_copy(0, ridx, torch.where(keep, upd, cur))

    return (scat(rgb, q["rgb"]), scat(opacity, q["opacity"]),
            scat(depth, q["depth"]), scat(T, q["T"], False),
            scat(t_cur, q["t_next"], False),
            scat(alive, q["alive"] & is_real, False))


def _drain_pool(params, cfg, occ_u8, ro, rdu, t2, rgb, opacity, depth, T,
                t_cur, alive, *, sr, max_passes, **kw):
    """Straggler drain: pull the first sr alive rays a trip until none is
    alive or `max_passes` trips ran.  Returns rgb, opacity, depth and the
    trip count."""
    const = torch.cat([ro, rdu, t2[:, None]], 1)
    state = torch.cat([rgb, opacity[:, None], depth[:, None], T[:, None],
                       t_cur[:, None], alive.to(torch.float32)[:, None]], 1)
    trips = 0
    while trips < max_passes:
        with span("ngp.serve.trip"):
            if not bool((state[:, 7] > 0.5).any()):
                break
            ridx, is_real = _first_k(state[:, 7] > 0.5, sr)
            cg = const.index_select(0, ridx)
            sg = state.index_select(0, ridx)
            q = _render_pass(params, cfg, occ_u8, cg[:, 0:3], cg[:, 3:6],
                             torch.where(is_real, sg[:, 6], math.inf),
                             torch.where(is_real, cg[:, 6], 0.0),
                             torch.where(is_real, sg[:, 5], 0.0), **kw)
            new = torch.cat(
                [sg[:, 0:3] + q["rgb"], (sg[:, 3] + q["opacity"])[:, None],
                 (sg[:, 4] + q["depth"])[:, None], q["T"][:, None],
                 q["t_next"][:, None],
                 (q["alive"] & is_real).to(torch.float32)[:, None]], 1)
            state.index_copy_(0, ridx,
                              torch.where(is_real[:, None], new, sg))
        trips += 1
        count("drain_trips")
    return state[:, 0:3], state[:, 3], state[:, 4], trips


def _main_pass_chunk(params, cfg, occ_u8, rays_o, rays_du, **kw):
    """AABB clip + one render pass for a chunk of unit-direction rays;
    returns the accumulators plus the (t2, t_next, T, alive) carry."""
    _, t2, t_cur = _clip(cfg, rays_o, rays_du)
    p = _render_pass(params, cfg, occ_u8, rays_o, rays_du, t_cur, t2,
                     torch.ones(rays_o.shape[0], device=rays_o.device), **kw)
    p["t2"] = t2
    return p


def _render_chunk_oneshot(params, cfg, occ_u8, rays_o, rays_d, *, passes,
                          straggler_div, budget_div, k, **kw):
    """One chunk with its own main pass and `passes - 1` straggler
    passes."""
    R = rays_o.shape[0]
    rays_du = rays_d / norm3(rays_d, keepdim=True)
    _, t2, t_cur = _clip(cfg, rays_o, rays_du)
    p = _render_pass(params, cfg, occ_u8, rays_o, rays_du, t_cur, t2,
                     torch.ones(R, device=rays_o.device), k=k,
                     budget=(R * k // budget_div if budget_div else 0), **kw)
    rgb, opacity, depth = p["rgb"], p["opacity"], p["depth"]
    T, t_cur, alive = p["T"], p["t_next"], p["alive"]
    sr = max(R // straggler_div, 1)
    for _ in range(passes - 1):
        rgb, opacity, depth, T, t_cur, alive = _straggler_pass(
            params, cfg, occ_u8, rays_o, rays_du, t2, rgb, opacity, depth,
            T, t_cur, alive, sr=sr, k=k,
            budget=(sr * k // max(budget_div // 2, 1) if budget_div else 0),
            **kw)
    return dict(rgb=rgb, opacity=opacity, depth=depth)


@torch.no_grad()
def render_test_oneshot(params, cfg: NGPConfig, occ_u8, rays_o, rays_d, *,
                        exp_step_factor: float = 0.0,
                        T_threshold: float = 1e-2, chunk: int = 131072,
                        k: int = 64, n_keep: int = 16, sup: int = 4,
                        n_keep_sup: int = 16, max_samples: int = 1024,
                        passes: int = 4, straggler_div: int = 4,
                        budget_div: int = 4, apply_fn=None,
                        pooled_stragglers: bool = True,
                        march: str = "seg", drain: bool = False,
                        max_passes: int = 1024,
                        compact_main: bool = False,
                        n_keep_super: int = 0,
                        drain_budget_div: int = 0):
    """Full-image one-shot renderer (bounded scenes), JAX's arguments.

    occ_u8: pack_occupancy_u8's word grid (march "seg"),
    pack_occupancy_blocks' rows ("block") or pack_occupancy_block2's dict
    ("block2").  apply_fn(params, cfg, x, d)
    -> (sigmas, rgbs) replaces the live field (e.g. make_baked_apply).
    pooled_stragglers: one main pass per chunk, then the alive rays of the
    whole image share the straggler passes; drain: those passes continue
    until no ray is alive (at most max_passes); compact_main (block2 +
    drain): no main pass, the drain starts from the rays a super scan
    marks live.  Returns rgb (R, 3), opacity, depth (R,), and with drain
    also drain_trips (int) and alive_after_main (int32 count)."""
    count("views")
    with span("ngp.serve.view"):
        if drain and not pooled_stragglers:
            raise ValueError("drain=True requires pooled_stragglers=True "
                             "(the drain runs on the image-wide pool)")
        dev = rays_o.device
        R = rays_o.shape[0]
        chunk = min(chunk, max(R, 1))
        pad = (-R) % chunk
        # pad rays start far outside the AABB: they never march content
        ro = (torch.cat([rays_o, torch.full((pad, 3), 100.0, device=dev)])
              if pad else rays_o)
        rd = (torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
              if pad else rays_d)
        bg = 1.0 if exp_step_factor == 0.0 else 0.0
        kw = dict(T_threshold=T_threshold, k=k, n_keep=n_keep, sup=sup,
                  n_keep_sup=n_keep_sup, max_samples=max_samples,
                  apply_fn=apply_fn, march=march)
        if not pooled_stragglers:
            outs = [_render_chunk_oneshot(
                params, cfg, occ_u8, ro[i:i + chunk], rd[i:i + chunk],
                passes=passes, straggler_div=straggler_div,
                budget_div=budget_div, **kw) for i in range(0, R + pad, chunk)]
            cat = {kk: torch.cat([o[kk] for o in outs])[:R] for kk in outs[0]}
            cat["rgb"] = cat["rgb"] + bg * (1.0 - cat["opacity"][:, None])
            return cat

        norm = norm3(rd, keepdim=True)
        rdu = rd / torch.where(norm > 0, norm, 1.0)
        N = R + pad
        sr = max(chunk // straggler_div, 1)
        if compact_main:
            # no main pass: the drain starts from every ray a phase-A super
            # scan finds possible content on, so background rays never march
            if march != "block2" or not drain:
                raise ValueError("compact_main requires march='block2' and "
                                 "drain=True")
            with span("ngp.serve.scan"):
                hits, t2, t_cur = _clip(cfg, ro, rdu)
                alive = super_any_live(
                    ro, rdu, hits, occ_u8, scale=cfg.scale,
                    grid_size=cfg.grid_size,
                    max_samples=max_samples) & (t_cur < t2)
            rgb = torch.zeros((N, 3), device=dev)
            opacity = torch.zeros((N,), device=dev)
            depth, T = torch.zeros_like(opacity), torch.ones_like(opacity)
        else:
            parts = [_main_pass_chunk(
                params, cfg, occ_u8, ro[i:i + chunk], rdu[i:i + chunk],
                budget=(chunk * k // budget_div if budget_div else 0), **kw)
                for i in range(0, N, chunk)]
            acc = {kk: torch.cat([p[kk] for p in parts]) for kk in parts[0]}
            rgb, opacity, depth = acc["rgb"], acc["opacity"], acc["depth"]
            T, t_cur = acc["T"], acc["t_next"]
            alive, t2 = acc["alive"], acc["t2"]
        out = {}
        if drain:
            rgb, opacity, depth, trips = _drain_pool(
                params, cfg, occ_u8, ro, rdu, t2, rgb, opacity, depth, T,
                t_cur, alive, sr=sr, max_passes=max_passes,
                n_keep_super=n_keep_super,
                budget=(sr * k // drain_budget_div if drain_budget_div else 0),
                **kw)
            out = dict(drain_trips=trips,
                       alive_after_main=alive.sum().to(torch.int32))
        else:
            for _ in range(passes - 1):
                rgb, opacity, depth, T, t_cur, alive = _straggler_pass(
                    params, cfg, occ_u8, ro, rdu, t2, rgb, opacity, depth, T,
                    t_cur, alive, sr=sr,
                    budget=(sr * k // max(budget_div // 2, 1) if budget_div
                            else 0), **kw)
        return dict(out, rgb=rgb[:R] + bg * (1.0 - opacity[:R, None]),
                    opacity=opacity[:R], depth=depth[:R])
