"""Front-to-back compositing over the ray-major packed sample stream (port
of google_nerf_tpu/ops/stream_composite.py).

Ray-major packing keeps each kept ray's samples contiguous and in
marching order, so the composite runs on the (B,) stream.  The per-ray
optical depth before each sample must not be a difference of one global
cumsum: an inf slot would turn every later ray into NaN, and precision
goes late in the stream.  Each ray's run (at most K slots) is therefore
laid onto its own row of an (R, K) grid and summed along the row; JAX
takes a segmented scan for the same values.  The seven per-ray sums
keep JAX's one (B, 7) global cumsum and its clamp of opacity to [0, 1].
Gradients are autograd's.
"""
from __future__ import annotations

import torch


def composite_stream_train(plan, sig_p, rgb_p, dt_p, ts_p, R: int, K: int,
                           T_threshold: float = 1e-4):
    """plan: ray-major PackPlan over an (R, K) valid grid whose valid
    entries are in ascending-t flat order.  sig_p (B,), rgb_p (B, 3),
    dt_p (B,), ts_p (B,): packed per-sample data.  Returns dict: opacity,
    depth, depth_sq, tau, t_last (R,), rgb (R, 3)."""
    B = sig_p.shape[0]
    dev = sig_p.device
    sv = plan.slot_valid
    # optical depth per slot, capped at 80 (exp(-80) is 0 against any
    # threshold), so a trunc_exp overflow cannot reach the sums below
    sd = torch.clamp_max(torch.where(sv, sig_p * dt_p, 0.0), 80.0)

    # each ray's [start, last] slot run
    keep2d = plan.keep.reshape(R, K)
    kidx = torch.arange(K, device=dev).expand(R, K)
    first_f = torch.where(keep2d, kidx, K).amin(-1)
    last_f = torch.where(keep2d, kidx, -1).amax(-1)
    count = keep2d.sum(-1)
    has = count > 0
    base = torch.arange(R, device=dev) * K
    start = plan.pos[base + torch.where(has, first_f, 0)]
    last = plan.pos[base + torch.where(has, last_f, 0)]

    # per-ray inclusive optical-depth prefix on the (R, K) grid: slot s of
    # ray r lands in cell (r, s - start[r]); empty slots in a spare cell.
    # The grid is filled by a scatter (its gradient is a gather) and read
    # back by a gather, so no pass adds many rows onto one.
    rid = torch.div(plan.src_idx, K, rounding_mode="floor")
    col = torch.arange(B, device=dev) - start[rid]
    cell = torch.where(sv, rid * K + col, R * K)
    grid = torch.zeros(R * K + 1, dtype=sd.dtype, device=dev).scatter(
        0, cell, sd)
    row_incl = torch.cat([torch.cumsum(grid[:-1].view(R, K), 1).view(-1),
                          grid[-1:]])
    seg_incl = row_incl.index_select(0, cell)
    T_before = torch.exp(-(seg_incl - sd))
    alpha = 1.0 - torch.exp(-sd)
    include = sv & (T_before > T_threshold)
    w = torch.where(include, T_before * alpha, 0.0)

    # the seven per-ray sums: one global cumsum over the stream (lanes
    # first, so the scan runs along contiguous memory), differenced at
    # each ray's run ends
    lanes = torch.stack(
        [w, w * ts_p, w * ts_p * ts_p,
         w * rgb_p[:, 0], w * rgb_p[:, 1], w * rgb_p[:, 2],
         torch.where(include, sd, 0.0)], dim=0)
    vc = torch.cumsum(lanes, 1)
    hi = vc.index_select(1, last)
    lo = torch.where(start > 0, vc.index_select(
        1, torch.clamp_min(start - 1, 0)), 0.0)
    sums = torch.where(has, hi - lo, 0.0)
    return dict(opacity=torch.clamp(sums[0], 0.0, 1.0),
                depth=sums[1], depth_sq=sums[2], rgb=sums[3:6].T,
                tau=sums[6], t_last=torch.where(has, ts_p[last], 0.0))
