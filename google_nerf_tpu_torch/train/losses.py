"""Training losses (port of google_nerf_tpu/train/losses.py): RGB MSE +
opacity entropy, and the shift/scale-invariant disparity loss."""
from __future__ import annotations

import dataclasses

import torch


def shiftscale_inv_depthloss(disp_pred, disp_gt):
    """Per-sample MiDaS shift/scale-invariant disparity loss (N,) -> (N,).
    The medians interpolate, as jnp.median does."""
    t_pred = torch.quantile(disp_pred, 0.5)
    s_pred = (disp_pred - t_pred).abs().mean()
    t_gt = torch.quantile(disp_gt, 0.5)
    s_gt = (disp_gt - t_gt).abs().mean()
    pred_n = (disp_pred - t_pred) / torch.clamp_min(s_pred, 1e-8)
    gt_n = (disp_gt - t_gt) / torch.clamp_min(s_gt, 1e-8)
    return (pred_n - gt_n) ** 2


@dataclasses.dataclass(frozen=True)
class NeRFLoss:
    lambda_opacity: float = 1e-3
    lambda_depth: float = 0.0

    def __call__(self, results, batch):
        d = {}
        d["rgb"] = (results["rgb"] - batch["rgb"]) ** 2
        # clamp: an f32 composite can round opacity epsilon-negative, and
        # log(<= 0) would NaN the whole gradient
        o = torch.clamp(results["opacity"], 0.0, 1.0) + 1e-10
        d["opacity"] = self.lambda_opacity * (-o * torch.log(o))
        if self.lambda_depth > 0 and "depth" in batch:
            valid = batch["depth"] > 0
            disp_pred = 1.0 / torch.clamp_min(results["depth"], 1e-6)
            disp_gt = 1.0 / torch.clamp_min(batch["depth"], 1e-6)
            loss = shiftscale_inv_depthloss(
                torch.where(valid, disp_pred, 0.0),
                torch.where(valid, disp_gt, 0.0))
            d["depth"] = self.lambda_depth * torch.where(valid, loss, 0.0)
        return d

    def total(self, results, batch):
        """Mean over rays; rays whose render the sample budget truncated
        (results["ray_mask"] False) are left out.  Returns the total and
        each term's mean ({rgb, opacity[, depth]})."""
        d = self(results, batch)
        mask = results.get("ray_mask")
        if mask is None:
            means = {k: v.mean() for k, v in d.items()}
            return sum(means.values()), means
        denom = torch.clamp_min(mask.sum(), 1)

        def ray_mean(v):
            m = mask.reshape((-1,) + (1,) * (v.ndim - 1))
            return torch.where(m, v, 0.0).sum() / (
                denom * (v[0].numel() if v.ndim > 1 else 1))

        means = {k: ray_mean(v) for k, v in d.items()}
        return sum(means.values()), means
