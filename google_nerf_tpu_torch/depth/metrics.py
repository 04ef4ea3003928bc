"""Monocular-depth error metrics, in numpy (port of
google_nerf_tpu/depth/metrics.py; the reference's
`Train/lib/utils/evaluate_depth_error.py`):
  * `recover_metric_depth` (`:7-30`): degree-1 polyfit of pred -> gt over
    valid pixels, returns rescaled pred.
  * `evaluate_rel_err` (`:73-151`): absRel, squaRel, rms, rms_log (silog),
    log10, delta1/2/3, WHDR.
  * `weighted_human_disagreement_rate` (`:154-175`) with the same
    deterministic point-pair selection scheme (numpy's default_rng(seed)
    pairs, as JAX's module draws them).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def recover_metric_depth(pred, gt, mask0=None):
    """Least-squares scale/shift fit of pred to gt on valid pixels."""
    pred = np.asarray(pred, np.float64).squeeze()
    gt = np.asarray(gt, np.float64).squeeze()
    mask = (gt > 1e-8) & (pred > 1e-8)
    if mask0 is not None:
        mask &= np.asarray(mask0).squeeze() > 0
    if mask.sum() < 2:
        return pred
    a, b = np.polyfit(pred[mask], gt[mask], deg=1)
    return a * pred + b


def evaluate_rel_err(pred, gt, mask_invalid=None, scale_fit: bool = True,
                     n_whdr_pairs: int = 10000,
                     seed: int = 0) -> Dict[str, float]:
    """Full error battery on a single image (or flattened batch)."""
    pred = np.asarray(pred, np.float64).squeeze()
    gt = np.asarray(gt, np.float64).squeeze()
    if scale_fit:
        pred = recover_metric_depth(pred, gt)
    mask = (gt > 1e-8) & (pred > 1e-8)
    if mask_invalid is not None:
        mask &= ~np.asarray(mask_invalid).squeeze().astype(bool)
    p, g = pred[mask], gt[mask]
    n = p.size
    if n < 2:
        return {}
    rel = np.abs(g - p) / g
    sq_rel = ((g - p) ** 2) / g
    ratio = np.maximum(p / g, g / p)
    lp, lg = np.log(np.maximum(p, 1e-12)), np.log(np.maximum(g, 1e-12))
    diff_log = lp - lg
    return {
        "err_absRel": float(rel.mean()),
        "err_squaRel": float(sq_rel.mean()),
        "err_rms": float(np.sqrt(((g - p) ** 2).mean())),
        "err_silog": float(np.sqrt(
            (diff_log ** 2).mean() - diff_log.mean() ** 2)),
        "err_logRms": float(np.sqrt((diff_log ** 2).mean())),
        "err_log10": float(np.abs(np.log10(np.maximum(p, 1e-12))
                                  - np.log10(np.maximum(g, 1e-12))).mean()),
        "err_delta1": float((ratio < 1.25).mean()),
        "err_delta2": float((ratio < 1.25 ** 2).mean()),
        "err_delta3": float((ratio < 1.25 ** 3).mean()),
        "err_whdr": weighted_human_disagreement_rate(
            g, p, n_pairs=n_whdr_pairs, seed=seed),
    }


def weighted_human_disagreement_rate(gt, pred, n_pairs: int = 10000,
                                     seed: int = 0) -> float:
    """Ordinal disagreement over random point pairs
    (`evaluate_depth_error.py:154-175`): pairs whose gt ratio differs by
    >= 2.5% are ordered; count pred disagreements."""
    gt = np.asarray(gt).reshape(-1)
    pred = np.asarray(pred).reshape(-1)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, gt.size, n_pairs)
    b = rng.integers(0, gt.size, n_pairs)
    thresh = 1.025
    g_ratio = (gt[a] + 1e-8) / (gt[b] + 1e-8)
    p_ratio = (pred[a] + 1e-8) / (pred[b] + 1e-8)
    g_ord = np.where(g_ratio > thresh, 1,
                     np.where(g_ratio < 1 / thresh, -1, 0))
    p_ord = np.where(p_ratio > thresh, 1,
                     np.where(p_ratio < 1 / thresh, -1, 0))
    valid = g_ord != 0
    if valid.sum() == 0:
        return 0.0
    return float((g_ord[valid] != p_ord[valid]).mean())
