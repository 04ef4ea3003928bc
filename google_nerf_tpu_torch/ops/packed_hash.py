"""Packed-corner multiresolution hash encoding, forward (port of
google_nerf_tpu/ops/packed_hash.py; the table gradient arrives with the
training slice).

All 8 trilinear corners of a cell live in ONE table row `(T, 8*F)`, so
the forward is one row gather per (sample, level).  Rows are gathered in
the table dtype (bf16 by default) and interpolated in f32, as in JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def _cell_keys(x, cfg: PackedHashConfig):
    """x: (N, 3) in [0,1] -> keys (L, N) int64 in [0, T), frac (L, N, 3).

    Dense levels (res^3 <= T) use the row-major cell index; finer levels
    the xor-prime hash of the cell coordinate.  JAX wraps the hash in
    uint32; here it runs in int64 masked to 32 bits, which gives the same
    bits (cell coordinates < 2^12, so no product overflows int64)."""
    T = cfg.table_size
    res_i = torch.tensor(cfg.resolutions, dtype=torch.int64,
                         device=x.device)
    dense = torch.tensor([r ** 3 <= T for r in cfg.resolutions],
                         device=x.device)
    res_f = res_i.to(x.dtype)[:, None, None]
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
    offs = torch.tensor([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                        device=frac.device)
    w = torch.where(offs == 1, f, 1.0 - f)                    # (..., 8, 3)
    return w[..., 0] * w[..., 1] * w[..., 2]


def packed_hash_encode(table, x, cfg: PackedHashConfig):
    """table: (L, T, 8F) f32; x: (N, 3) in [0, 1] -> (N, L*F) f32."""
    L = table.shape[0]
    F = cfg.n_features
    N = x.shape[0]
    keys, frac = _cell_keys(x, cfg)
    gd = getattr(torch, cfg.table_dtype)
    rows = torch.stack([table[l].to(gd)[keys[l]] for l in range(L)])
    rows = rows.reshape(L, N, 8, F).float()
    w = _corner_weights(frac)                                 # (L, N, 8)
    feat = (w[..., None] * rows).sum(-2)                      # (L, N, F)
    return feat.permute(1, 0, 2).reshape(N, L * F)
