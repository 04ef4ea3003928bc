"""Front-to-back volume compositing over padded (R, K) sample grids (port
of google_nerf_tpu/ops/composite.py): the training composite and the
per-round test composite.  Transmittance before sample i is
exp(-exclusive_sum(sigma*delta)) in JAX's form, the inclusive cumsum
minus the sample (a shifted cumsum rounds differently).  The training
composite's gradient is autograd's through the same masked expression,
as JAX's is XLA autodiff's: the T_threshold mask is a hard boundary."""
from __future__ import annotations

import torch


def _exclusive_cumsum(x, dim: int = -1):
    return torch.cumsum(x, dim) - x


def composite_rays_train(sigmas, rgbs, deltas, ts, valid, T_threshold=1e-4):
    """sigmas (R, K), rgbs (R, K, 3), deltas (R, K), ts (R, K), valid
    (R, K) -> dict opacity (R,), depth (R,), depth_sq (R,), rgb (R, 3),
    ws (R, K)."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    T_before = torch.exp(-_exclusive_cumsum(sd))
    alpha = 1.0 - torch.exp(-sd)
    include = valid & (T_before > T_threshold)
    w = torch.where(include, T_before * alpha, 0.0)
    return dict(opacity=w.sum(-1), depth=(w * ts).sum(-1),
                depth_sq=(w * ts * ts).sum(-1),
                rgb=(w[..., None] * rgbs).sum(-2), ws=w)


def composite_rays_test_round(sigmas, rgbs, deltas, ts, valid, T_carry,
                              opacity, depth, rgb, T_threshold=1e-4):
    """One test-time marching round composited onto running accumulators.

    T_carry (R,): the transmittance earlier rounds left; opacity, depth
    (R,) and rgb (R, 3) accumulate.  Returns the updated (T, opacity,
    depth, rgb); a ray has converged when T <= T_threshold."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    T_before = T_carry[:, None] * torch.exp(-_exclusive_cumsum(sd))
    alpha = 1.0 - torch.exp(-sd)
    include = valid & (T_before > T_threshold)
    w = torch.where(include, T_before * alpha, 0.0)
    opacity = opacity + w.sum(-1)
    depth = depth + (w * ts).sum(-1)
    rgb = rgb + (w[..., None] * rgbs).sum(-2)
    T_new = T_carry * torch.exp(-torch.where(include, sd, 0.0).sum(-1))
    return T_new, opacity, depth, rgb
