"""The numbers `correct` compares, each a gap against the reference."""
from __future__ import annotations

import statistics
from typing import Dict

import torch


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norm_gap(prog: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor], keys=None):
    """Worst leaf of |norm(prog) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's.  Returns (worst, per
    leaf)."""
    keys = list(ref) if keys is None else list(keys)
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = statistics.median(rn.values())
    gaps = {k: abs(float(prog[k].double().norm()) - rn[k])
            / max(rn[k], med, 1e-30) for k in keys}
    return max(gaps.values()), gaps


def moved_leaves(ref_grads: Dict[str, torch.Tensor], floor: float = 1e-3):
    """Leaves whose reference gradient is not nought to rounding: norm
    at least `floor` of the median leaf's."""
    rn = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    med = statistics.median(rn.values())
    return [k for k, v in rn.items() if v >= floor * med]


def pixel_errors(got: torch.Tensor, want: torch.Tensor, q: float = 0.999):
    """Per-pixel absolute error (the worst channel): its q-quantile,
    mean and max."""
    e = (got.float() - want.float()).abs()
    if e.ndim > 1:
        e = e.amax(-1)
    e = e.reshape(-1)
    k = max(1, int(round(q * e.numel())))
    return (float(torch.kthvalue(e.cpu(), k).values), float(e.mean()),
            float(e.max()))
