"""Front-to-back volume compositing over padded (R, K) sample grids
(forward of google_nerf_tpu/ops/composite.py composite_rays_train)."""
from __future__ import annotations

import torch


def composite_rays_train(sigmas, rgbs, deltas, ts, valid, T_threshold=1e-4):
    """sigmas (R, K), rgbs (R, K, 3), deltas (R, K), ts (R, K), valid
    (R, K) -> dict opacity (R,), depth (R,), depth_sq (R,), rgb (R, 3),
    ws (R, K)."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    T_before = torch.exp(-(torch.cumsum(sd, -1) - sd))
    alpha = 1.0 - torch.exp(-sd)
    include = valid & (T_before > T_threshold)
    w = torch.where(include, T_before * alpha, 0.0)
    return dict(opacity=w.sum(-1), depth=(w * ts).sum(-1),
                depth_sq=(w * ts * ts).sum(-1),
                rgb=(w[..., None] * rgbs).sum(-2), ws=w)
