"""The two helpers of google_nerf_tpu/ops/march_seg.py that the block2
marcher uses; the segment marcher itself is ROADMAP item 14."""
from __future__ import annotations

import torch


def _cell_index_single(xyz, scale: float, grid_size: int):
    """Single-cascade cell integer coords (int32), as JAX's: clip the
    unit-cube position to [0, 1 - 0.5/G], scale by G, truncate."""
    bound = min(0.5, scale)
    nf = torch.clamp((0.5 / bound) * xyz + 0.5, 0.0,
                     1.0 - 0.5 / grid_size) * grid_size
    return nf.to(torch.int32)


def _first_k(mask, K: int):
    """The first K set entries of each row of mask (..., n): their
    indices in ascending order, and whether each pick is a set entry.
    topk on JAX's score (-iota where set): set entries' scores are
    unique, so they come out in index order; unset picks are masked by
    every caller."""
    n = mask.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    score = torch.where(mask, -iota, -(n + 1))
    vals, idx = torch.topk(score, K, dim=-1)
    return idx, vals > -(n + 1)
