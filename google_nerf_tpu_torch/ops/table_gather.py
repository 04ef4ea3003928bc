"""Trainable-table gathers with an f32 segment-sum gradient (port of
google_nerf_tpu/ops/table_gather.py).

  * table_gather (M, F) -> (N, F): the forward is a plain row take (JAX's
    jnp.take); the table gradient sums g by index;
  * batched_table_gather (L, T, F) -> (L, M, F) f32, the row traffic of
    the hash encoder's plain path (CPU tensors, and card inputs that
    ops/cuda/hash_grid's kernels do not take; on the card the encoder's
    rows otherwise never leave those kernels' registers): the forward
    takes each level's rows from a `gather_dtype` (bf16 by default) copy
    of the table and casts them to f32, as JAX does; JAX computes it in
    XLA, outside any Pallas kernel, so it stays `index_select` here (P2
    moves 16-byte words and a hash row is 4 bytes).

Both gradients are the f32 segment sum of g by row (over the (L*T, F)
view for the batched gather) through P3 (`scatter_add_rows`,
ops/cuda/probe.py): JAX's sort-based reduction fixes what is summed, not
how.  table_gather's bwd_mode "scatter" takes P3's plain version, zeros
+ `index_add_`, as JAX's "scatter" takes XLA's scatter-add.  CPU tensors
take the plain version either way.  The scatter is looked up on this
module at call time, so a caller can swap in the plain version on the
card.
"""
from __future__ import annotations

import torch

from google_nerf_tpu_torch.ops.cuda.probe import (scatter_add_rows,
                                                  scatter_add_rows_plain)
from google_nerf_tpu_torch.ops.packed_hash import _rows_index

BWD_MODES = ("sorted", "scatter")


def _segment_sum(rows, g, n_rows: int, bwd_mode: str):
    """(n_rows, F) f32: out[rows[i]] += g[i]."""
    vals = g.float().reshape(rows.shape[0], -1).contiguous()
    scatter = (scatter_add_rows if bwd_mode == "sorted"
               else scatter_add_rows_plain)
    return scatter(rows, vals, n_rows)


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, bwd_mode):
        rows = idx.to(torch.int32).contiguous()
        ctx.save_for_backward(rows)
        ctx.m, ctx.bwd_mode = table.shape[0], bwd_mode
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return _segment_sum(rows, g, ctx.m, ctx.bwd_mode), None, None


def table_gather(table, idx, bwd_mode: str = "sorted"):
    """table: (M, F); idx: (N,) int in [0, M) -> (N, F) table[idx], with
    the table gradient summed by index (bwd_mode "sorted": P3; "scatter":
    its plain version)."""
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"bwd_mode={bwd_mode!r}: expected one of "
                         f"{BWD_MODES}")
    return _TableGather.apply(table, idx, bwd_mode)


class _BatchedTableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, gather_dtype):
        L, T, F = table.shape
        rows = _rows_index(idx.to(torch.int64), T)
        tab = table.to(getattr(torch, gather_dtype)).reshape(L * T, F)
        ctx.save_for_backward(rows)
        ctx.shape = (L, T, F)
        return tab.index_select(0, rows).float().reshape(L, -1, F)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        L, T, F = ctx.shape
        dt = _segment_sum(rows, g, L * T, "sorted").view(L, T, F)
        return dt, None, None


def batched_table_gather(table, idx, gather_dtype: str = "bfloat16"):
    """table: (L, T, F) f32; idx: (L, M) int in [0, T) -> (L, M, F) f32:
    row idx[l, m] of level l, taken from the table cast to gather_dtype.
    The f32 table gradient of each level sums g by index."""
    return _BatchedTableGather.apply(table, idx, gather_dtype)
