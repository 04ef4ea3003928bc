"""Input encodings (port of google_nerf_tpu/models/encoders.py): the
frequency encoding (the fork's xyz encoder), spherical harmonics of
degree 4 (directions) and the multiresolution hash grid (the reference's
Instant-NGP path, `ngp_pl/models/networks.py:38-47`).

The hash grid's dense levels ((r+1)^3 <= T) index vertices x-fastest,
c0 + c1*(r+1) + c2*(r+1)^2; finer levels hash the vertex with the
instant-ngp xor primes.  Corners are not clipped before hashing: only
the final index is.  JAX hashes in uint32; here the products run in
int64 masked to 32 bits, which gives the same bits.  Row traffic rides
ops/table_gather.batched_table_gather (bf16 rows forward, the f32 table
gradient on P3).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from google_nerf_tpu_torch.ops.packed_hash import _corner_weights
from google_nerf_tpu_torch.ops.table_gather import batched_table_gather

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def frequency_encode(x: torch.Tensor, n_freqs: int = 12) -> torch.Tensor:
    """NeRF positional encoding, bands 2^i * pi: (..., D) -> (...,
    D*2*n_freqs), per input dim n_freqs sines then n_freqs cosines."""
    freqs = (2.0 ** torch.arange(n_freqs, dtype=x.dtype,
                                 device=x.device)) * math.pi
    ang = x[..., None] * freqs
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_freqs)


def sh_encode_deg4(d: torch.Tensor) -> torch.Tensor:
    """d: (..., 3) unit directions -> (..., 16) real SH basis values."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ]
    return torch.stack(comps, dim=-1)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3819  # exp(ln(2048*scale/16)/(L-1)), scale .5
    table_dtype: str = "bfloat16"    # gather dtype (params stay f32)

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def resolutions(self):
        return tuple(
            int(np.floor(self.base_resolution * self.per_level_scale ** l))
            for l in range(self.n_levels))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def hashgrid_config_for_scale(scale: float, num_levels: int = 16,
                              **kw) -> HashGridConfig:
    """The reference's b = exp(ln(2048*scale/N_min)/(L-1))."""
    n_min = kw.pop("base_resolution", 16)
    b = float(np.exp(np.log(2048 * scale / n_min) / (num_levels - 1)))
    return HashGridConfig(n_levels=num_levels, base_resolution=n_min,
                          per_level_scale=b, **kw)


def init_hashgrid(generator: torch.Generator, cfg: HashGridConfig,
                  device="cuda") -> torch.Tensor:
    """(L, T, F) f32, U[-1e-4, 1e-4] (tcnn's init)."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * 1e-4).to(device)


@functools.lru_cache(maxsize=None)
def _consts(cfg: HashGridConfig, device: str):
    """Per-level resolutions (int64, f32), dense-level flags and the
    corner offsets (8, 3) int64 on `device`, made once (a host-to-device
    copy inside a train step would sync the host)."""
    res = torch.tensor(cfg.resolutions, dtype=torch.int64, device=device)
    dense = torch.tensor([(r + 1) ** 3 <= cfg.table_size
                          for r in cfg.resolutions], device=device)
    offs = torch.tensor([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                        dtype=torch.int64, device=device)
    return res, res.to(torch.float32), dense, offs


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


def hash_encode(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """table: (L, T, F) f32; x: (N, 3) in [0, 1] -> (N, L*F) features.

    Per level: x scaled by the level's resolution, the 8 surrounding
    vertices trilinearly interpolated.  The gradient reaches the table
    through batched_table_gather and x through the corner weights."""
    L, T, F = table.shape
    N = x.shape[0]
    res_i, res_f, dense, offs = _consts(cfg, str(x.device))
    res_f = res_f.to(x.dtype)[:, None, None]
    pos = x[None] * res_f                                     # (L, N, 3)
    c0f = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0),
                        res_f - 1).detach()
    frac = pos - c0f
    c = c0f.to(torch.int64)[:, None] + offs[None, :, None]    # (L, 8, N, 3)
    idx = _corner_indices(c, dense, res_i, T).reshape(L, 8 * N)
    w = _corner_weights(frac).permute(0, 2, 1)                # (L, 8, N)
    feats = batched_table_gather(table, idx, cfg.table_dtype).reshape(
        L, 8, N, F)
    out = (w[..., None] * feats).sum(1)                       # (L, N, F)
    return out.permute(1, 0, 2).reshape(N, L * F)
