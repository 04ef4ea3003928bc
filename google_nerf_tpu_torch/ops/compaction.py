"""Sample compaction: pack the valid (ray, sample) slots into a fixed
budget before the field runs (port of google_nerf_tpu/ops/compaction.py).

Shapes stay static, as in JAX: a plan maps each of B budget slots to a
flat source slot and each source slot to its budget slot.  pack and
unpack are gathers whose gradients are gathers through the inverse map
(the kept slots and the budget slots are a bijection), so neither pass
adds rows in a data-dependent order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PackPlan(NamedTuple):
    src_idx: torch.Tensor     # (B,) flat source index of each budget slot
    pos: torch.Tensor         # (N,) budget slot of each flat source (B-1 if
                              # not kept)
    keep: torch.Tensor        # (N,) bool: valid and within budget
    slot_valid: torch.Tensor  # (B,) bool: slot holds a real sample
    n_valid: torch.Tensor     # () valid samples before the budget


def plan_packing(valid: torch.Tensor, budget: int,
                 sample_major: bool = True) -> PackPlan:
    """valid: (R, K) bool -> packing plan for budget B = min(budget, R*K).

    sample_major fills budget slots sample-slot-major (every ray's sample
    0, then sample 1, ...), so a truncating budget drops only far tails;
    ray-major (False) keeps each kept ray's samples contiguous and in
    order, which the stream composite needs."""
    R, K = valid.shape
    flat = valid.reshape(-1)
    n = flat.shape[0]
    budget = min(budget, n)
    if not sample_major:
        return _plan_packing_rowmajor(valid, budget)
    dev = valid.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rank = (torch.arange(K, device=dev)[None, :] * R
            + torch.arange(R, device=dev)[:, None]).reshape(-1)
    pos = (torch.cumsum(valid.T.reshape(-1).long(), 0)
           .reshape(K, R).T.reshape(-1)) - 1
    key = torch.where(flat, rank, n)
    sorted_key, order = torch.sort(key, stable=True)
    slot_valid = sorted_key[:budget] < n
    src_idx = torch.where(slot_valid, iota[order[:budget]], 0)
    keep = flat & (pos < budget)
    pos = torch.where(keep, pos, budget - 1)
    return PackPlan(src_idx, pos, keep, slot_valid, flat.sum())


def _plan_packing_rowmajor(valid: torch.Tensor, budget: int) -> PackPlan:
    """Ray-major plan without a global sort: per-ray counts give each
    ray's budget offset; a budget slot's ray is the running max of the
    rays marked at their first slot; its column comes from the row's
    sorted valid columns."""
    R, K = valid.shape
    dev = valid.device
    counts = valid.sum(1)                                    # (R,)
    total = counts.sum()
    off = torch.cumsum(counts, 0) - counts                   # exclusive
    rowrank = torch.cumsum(valid.long(), 1) - 1              # (R, K)
    flat = valid.reshape(-1)
    posv = (off[:, None] + rowrank).reshape(-1)
    keep = flat & (posv < budget)
    pos = torch.where(keep, posv, budget - 1)
    kidx = torch.arange(K, device=dev).expand(R, K)
    jth = torch.sort(torch.where(valid, kidx, K), dim=1).values
    # budget slot -> ray: mark each content ray at its first slot, then
    # running max (a zero-count ray shares its offset with the next content
    # ray, which has the larger id); slots past the budget are dropped
    ids = torch.arange(R, device=dev)
    at = torch.where((counts > 0) & (off < budget), off, budget)
    marks = torch.full((budget + 1,), -1, dtype=torch.int64, device=dev)
    marks = marks.scatter_reduce(0, at, ids, "amax")[:budget]
    rb = torch.cummax(marks, 0).values.clamp_min(0)
    bidx = torch.arange(budget, device=dev)
    jb = bidx - off[rb]
    col = jth.reshape(-1)[rb * K + jb.clamp(0, K - 1)]
    slot_valid = bidx < torch.clamp_max(total, budget)
    src_idx = torch.where(slot_valid, rb * K + torch.clamp_max(col, K - 1), 0)
    return PackPlan(src_idx, pos, keep, slot_valid, total)


def _rows_mask(mask, like):
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


class _Pack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src_idx, pos, keep):
        ctx.save_for_backward(pos, keep)
        return x.index_select(0, src_idx)

    @staticmethod
    def backward(ctx, g):
        pos, keep = ctx.saved_tensors
        dx = torch.where(_rows_mask(keep, g), g.index_select(0, pos), 0.0)
        return dx, None, None, None


class _Unpack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, src_idx, pos, keep, slot_valid):
        ctx.save_for_backward(src_idx, slot_valid)
        return torch.where(_rows_mask(keep, y), y.index_select(0, pos), 0.0)

    @staticmethod
    def backward(ctx, g):
        src_idx, slot_valid = ctx.saved_tensors
        dy = torch.where(_rows_mask(slot_valid, g),
                         g.index_select(0, src_idx), 0.0)
        return dy, None, None, None, None


def pack(x: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """x: (N, ...) -> (B, ...) gathered at the plan's source indices."""
    return _Pack.apply(x, plan.src_idx, plan.pos, plan.keep)


def unpack(y: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """y: (B, ...) -> (N, ...): inverse of pack; slots not kept are 0."""
    return _Unpack.apply(y, plan.src_idx, plan.pos, plan.keep,
                         plan.slot_valid)
