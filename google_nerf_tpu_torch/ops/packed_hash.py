"""Packed-corner multiresolution hash encoding with its gradient (port
of google_nerf_tpu/ops/packed_hash.py).

All 8 trilinear corners of a cell live in ONE table row `(T, 8*F)`, so
the forward is one row gather per (sample, level): P2 (`gather_rows`,
ops/cuda/probe.py) on the table cast to the gather dtype (bf16 by
default) and viewed as (L*T, 8F), at the int32 rows keys + l*T.  Rows
are interpolated in f32, as in JAX.  The backward is JAX's custom VJP in
f32: the table gradient sums the payloads w (x) g per (level, key) with
P3 (`scatter_add_rows`) into (L*T, 8F) f32, never through a bf16 copy of
the gradient; dx is the corner-weight derivative scaled by the level
resolutions.  CPU tensors take P2's and P3's plain versions.  The
gather and scatter are looked up on this module at call time, so a
caller can swap in the plain versions on the card.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from google_nerf_tpu_torch.ops.cuda.probe import gather_rows, scatter_add_rows

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PackedHashConfig:
    n_levels: int = 8
    n_features: int = 2           # features per corner (output dim = L*F)
    log2_table_size: int = 16     # cells per level
    base_resolution: int = 16
    per_level_scale: float = 2.0  # set via packed_config_for_scale
    table_dtype: str = "bfloat16"  # gather dtype (params stay f32)

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def resolutions(self):
        return tuple(
            int(np.floor(self.base_resolution * self.per_level_scale ** l))
            for l in range(self.n_levels))

    @property
    def row_width(self) -> int:
        return 8 * self.n_features

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def packed_config_for_scale(scale: float, n_levels: int = 8,
                            max_resolution: int = 0,
                            **kw) -> PackedHashConfig:
    """N_min..N_max span of the reference hash grid (N_max = 2048*scale
    unless `max_resolution` overrides it)."""
    n_min = kw.pop("base_resolution", 16)
    n_max = max(max_resolution or 2048 * scale, n_min + 1)
    b = float(np.exp(np.log(n_max / n_min) / max(n_levels - 1, 1)))
    return PackedHashConfig(n_levels=n_levels, base_resolution=n_min,
                            per_level_scale=b, **kw)


def init_packed_hash(generator: torch.Generator, cfg: PackedHashConfig,
                     device="cuda") -> torch.Tensor:
    """(L, T, 8F) f32, U[-1e-4, 1e-4] (tcnn's init)."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.row_width),
                   generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * 1e-4).to(device)


@functools.lru_cache(maxsize=None)
def _consts(cfg: PackedHashConfig, device: str):
    """Per-level resolutions (int64, f32) and dense-level flags on
    `device`, made once: a host-to-device copy inside a train step would
    sync the host."""
    res = torch.tensor(cfg.resolutions, dtype=torch.int64, device=device)
    dense = torch.tensor([r ** 3 <= cfg.table_size for r in cfg.resolutions],
                         device=device)
    return res, res.to(torch.float32), dense


@functools.lru_cache(maxsize=None)
def _offset_bits(device: str):
    """(8, 3) bool: corner c's offset bit k = (c >> k) & 1, on device."""
    return torch.tensor([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                        device=device) == 1


def _cell_keys(x, cfg: PackedHashConfig):
    """x: (N, 3) in [0,1] -> keys (L, N) int64 in [0, T), frac (L, N, 3).

    Dense levels (res^3 <= T) use the row-major cell index; finer levels
    the xor-prime hash of the cell coordinate.  JAX wraps the hash in
    uint32; here it runs in int64 masked to 32 bits, which gives the same
    bits (cell coordinates < 2^12, so no product overflows int64)."""
    T = cfg.table_size
    res_i, res_f, dense = _consts(cfg, str(x.device))
    res_f = res_f.to(x.dtype)[:, None, None]
    pos = x[None] * res_f                                     # (L, N, 3)
    c0f = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0), res_f - 1)
    c0 = c0f.to(torch.int64)
    frac = pos - c0f
    r = res_i[:, None]
    dense_idx = (c0[..., 0] * r + c0[..., 1]) * r + c0[..., 2]
    h = (((c0[..., 0] * _PRIMES[0]) & _U32)
         ^ ((c0[..., 1] * _PRIMES[1]) & _U32)
         ^ ((c0[..., 2] * _PRIMES[2]) & _U32)) & (T - 1)
    idx = torch.where(dense[:, None], dense_idx, h)
    return idx.clamp(0, T - 1), frac


def _corner_weights(frac):
    """frac: (..., 3) -> (..., 8) trilinear weights; corner c takes offset
    bit k = (c >> k) & 1 on axis k."""
    f = frac[..., None, :]                                    # (..., 1, 3)
    w = torch.where(_offset_bits(str(frac.device)), f, 1.0 - f)  # (..., 8, 3)
    return w[..., 0] * w[..., 1] * w[..., 2]


def _corner_weight_grads(frac):
    """d w_c / d frac_k: (..., 8, 3)."""
    f = frac[..., None, :]
    offs = _offset_bits(str(frac.device))
    term = torch.where(offs, f, 1.0 - f)                      # (..., 8, 3)
    sign = torch.where(offs, 1.0, -1.0)
    grads = []
    for k in range(3):
        others = [term[..., j] for j in range(3) if j != k]
        grads.append(sign[..., k] * others[0] * others[1])
    return torch.stack(grads, -1)                             # (..., 8, 3)


def _rows_index(keys, T: int):
    """keys (L, N) -> int32 rows keys + l*T of the (L*T, W) table view."""
    L = keys.shape[0]
    lev = torch.arange(L, dtype=torch.int64, device=keys.device)[:, None]
    return (keys + lev * T).reshape(-1).to(torch.int32)


class _PackedHashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, cfg):
        L, T, W = table.shape
        F = cfg.n_features
        N = x.shape[0]
        keys, frac = _cell_keys(x, cfg)
        idx = _rows_index(keys, T)
        tab = table.to(getattr(torch, cfg.table_dtype)).reshape(L * T, W)
        rows = gather_rows(tab, idx)                          # (L*N, W)
        w = _corner_weights(frac)                             # (L, N, 8)
        rowsf = rows.reshape(L, N, 8, F).float()
        feat = (w[..., None] * rowsf).sum(-2)                 # (L, N, F)
        ctx.cfg, ctx.shape = cfg, (L, T, W)
        ctx.save_for_backward(idx, frac, rows, w)
        return feat.permute(1, 0, 2).reshape(N, L * F)

    @staticmethod
    def backward(ctx, g):
        idx, frac, rows, w = ctx.saved_tensors
        cfg, (L, T, W) = ctx.cfg, ctx.shape
        F = cfg.n_features
        N = frac.shape[1]
        gl = g.float().reshape(N, L, F).permute(1, 0, 2)      # (L, N, F)
        dtable = dx = None
        if ctx.needs_input_grad[0]:
            payload = (w[..., :, None] * gl[..., None, :]).reshape(L * N, W)
            dtable = scatter_add_rows(idx, payload, L * T).view(L, T, W)
        if ctx.needs_input_grad[1]:
            rowsf = rows.reshape(L, N, 8, F).float()
            rg = (rowsf * gl[..., None, :]).sum(-1)           # (L, N, 8)
            dfrac = (rg[..., None] * _corner_weight_grads(frac)).sum(-2)
            res = _consts(cfg, str(frac.device))[1]
            dx = (dfrac * res[:, None, None]).sum(0)          # (N, 3)
        return dtable, dx, None


def packed_hash_encode(table, x, cfg: PackedHashConfig):
    """table: (L, T, 8F) f32; x: (N, 3) in [0, 1] -> (N, L*F) f32, with
    the f32 table gradient and dx described in the module notes."""
    return _PackedHashEncode.apply(table, x, cfg)
