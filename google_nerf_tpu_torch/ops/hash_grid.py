"""The hash grid's plain arithmetic (port of the corner arithmetic of
google_nerf_tpu/models/encoders.py), in tensor ops: the one plain
version of what ops/cuda/hash_grid's kernels compute in registers.
models/encoders.hash_encode runs it on CPU tensors, and the kernels'
plain versions (ops/cuda/hash_grid.*_plain) are built from it.

Per level of resolution r: pos = x * r; the low corner c0 = min(max(
floor(pos), 0), r - 1) and frac = pos - c0; corner c takes offset bit k
= (c >> k) & 1 on axis k.  Dense levels ((r+1)^3 <= T) index vertices
x-fastest, c0 + c1*(r+1) + c2*(r+1)^2; finer levels hash the vertex with
the instant-ngp xor primes.  Corners are not clipped before hashing:
only the final index is.  JAX hashes in uint32; here the products run in
int64 masked to 32 bits, which gives the same bits.  The 8 corners'
w_c * row_c are added in order c = 0..7, as the kernel adds them, so
the kernel's features equal these bit for bit.
"""
from __future__ import annotations

import functools

import torch

from google_nerf_tpu_torch.ops.packed_hash import _corner_weights
from google_nerf_tpu_torch.ops.table_gather import batched_table_gather

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _corner_indices(c, level_dense, resolutions, T: int):
    """c: (L, ..., 3) int64 corner coords -> (L, ...) table index per
    level: dense (x-fastest) where level_dense, else the xor-prime hash;
    clipped to [0, T)."""
    shape = (-1,) + (1,) * (c.ndim - 2)
    res1 = (resolutions + 1).reshape(shape)
    dense_idx = c[..., 0] + c[..., 1] * res1 + c[..., 2] * res1 * res1
    h = (((c[..., 0] * _PRIMES[0]) & _U32)
         ^ ((c[..., 1] * _PRIMES[1]) & _U32)
         ^ ((c[..., 2] * _PRIMES[2]) & _U32)) & (T - 1)
    idx = torch.where(level_dense.reshape(shape), dense_idx, h)
    return idx.clamp(0, T - 1)


@functools.lru_cache(maxsize=None)
def level_consts(res: tuple, T: int, device: str):
    """Per-level resolutions (int64, f32), dense-level flags and the
    corner offsets (8, 3) int64 on `device`, made once (a host-to-device
    copy inside a train step would sync the host)."""
    res_i = torch.tensor(res, dtype=torch.int64, device=device)
    dense = torch.tensor([(r + 1) ** 3 <= T for r in res], device=device)
    offs = torch.tensor([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                        dtype=torch.int64, device=device)
    return res_i, res_i.to(torch.float32), dense, offs


def corners(x, res: tuple, T: int):
    """x (N, 3) -> (idx (L, 8, N) int64, w (L, 8, N), frac (L, N, 3)):
    every corner's table index and trilinear weight on the L levels of
    resolutions res; the gradient reaches x through frac."""
    res_i, res_f, dense, offs = level_consts(tuple(res), T, str(x.device))
    r = res_f.to(x.dtype)[:, None, None]
    pos = x[None] * r                                         # (L, N, 3)
    c0f = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0),
                        r - 1).detach()
    frac = pos - c0f
    c = c0f.to(torch.int64)[:, None] + offs[None, :, None]    # (L, 8, N, 3)
    idx = _corner_indices(c, dense, res_i, T)
    return idx, _corner_weights(frac).permute(0, 2, 1), frac


def corner_rows(table, idx, gather_dtype: str):
    """table (L, T, F), idx (L, 8, N) -> the rows (L, 8, N, F) f32, taken
    from the table cast to gather_dtype (batched_table_gather)."""
    L, _, F = table.shape
    return batched_table_gather(table, idx.reshape(L, -1),
                                gather_dtype).reshape(*idx.shape, F)


def corner_sum(w, rows):
    """w (L, 8, N), rows (L, 8, N, F) -> (L, N, F): the corners' w_c *
    row_c added in order c = 0..7."""
    out = w[:, 0, :, None] * rows[:, 0]
    for c in range(1, 8):
        out = out + w[:, c, :, None] * rows[:, c]
    return out


def encode(table, x, res: tuple, gather_dtype: str):
    """table (L, T, F), x (N, 3) -> features (N, L*F) f32: per level the
    8 corners of x's cell, their rows in gather_dtype widened to f32,
    trilinearly summed.  The table's gradient is batched_table_gather's,
    x's comes through the weights."""
    L, T, F = table.shape
    idx, w, _ = corners(x, res, T)
    out = corner_sum(w, corner_rows(table, idx, gather_dtype))
    return out.permute(1, 0, 2).reshape(x.shape[0], L * F)
