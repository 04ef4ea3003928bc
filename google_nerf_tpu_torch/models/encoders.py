"""Input encodings (port of google_nerf_tpu/models/encoders.py): the
frequency encoding (the fork's xyz encoder), spherical harmonics of
degree 4 (directions) and the multiresolution hash grid (the reference's
Instant-NGP path, `ngp_pl/models/networks.py:38-47`).

The hash grid's arithmetic is ops/hash_grid's (dense levels indexed
x-fastest, finer ones hashed with the instant-ngp xor primes).  On the
card its row traffic never leaves registers: CUDA tensors go through
ops/cuda/hash_grid's two kernels (the features; the table gradient by
atomics and, when x needs one, its gradient), with no (L, 8, N)
intermediate in device memory; their wrappers refuse a table of a width
or a gather dtype they have no instance for.  CPU tensors take the
plain path: ops/hash_grid.encode, whose rows come through
ops/table_gather.batched_table_gather (bf16 rows forward, the f32 table
gradient summed by row).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from google_nerf_tpu_torch.ops.cuda.hash_grid import (hash_grid_encode,
                                                     hash_grid_grads)
from google_nerf_tpu_torch.ops.hash_grid import encode
from google_nerf_tpu_torch.utils.logging import count


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


class _HashGrid(torch.autograd.Function):
    """hash_encode on the card: ops/cuda/hash_grid's kernels, the
    gather-dtype copy of the table made once a call.  The wrappers are
    looked up on this module at call time, so a caller can swap in their
    plain versions."""

    @staticmethod
    def forward(ctx, table, x, res, gather_dtype):
        tab = table.to(gather_dtype).contiguous()
        ctx.res, ctx.shape = res, table.shape
        ctx.save_for_backward(x, tab if ctx.needs_input_grad[1] else None)
        return hash_grid_encode(tab, x, res)

    @staticmethod
    def backward(ctx, g):
        x, tab = ctx.saved_tensors
        dt, dx = hash_grid_grads(
            g.float().contiguous(), x, tab, ctx.res, tuple(ctx.shape),
            ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dt, dx, None, None


def hash_encode(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """table: (L, T, F) f32; x: (N, 3) in [0, 1] -> (N, L*F) features.

    Per level: x scaled by the level's resolution, the 8 surrounding
    vertices trilinearly interpolated.  CUDA tensors take
    ops/cuda/hash_grid's kernels, which give the table's gradient and
    x's; CPU tensors take the plain path, ops/hash_grid.encode."""
    if table.is_cuda or x.is_cuda:
        count("enc_fused_points", x.shape[0])
        return _HashGrid.apply(table, x.contiguous(), cfg.resolutions,
                               getattr(torch, cfg.table_dtype))
    return encode(table, x, cfg.resolutions, cfg.table_dtype)
