"""Morton (Z-order) encode/decode and bitfield packing (port of
google_nerf_tpu/ops/morton.py).

The reference's `vren.morton3D / morton3D_invert / packbits`.  The
occupancy grid stays in raster (C, G, G, G) layout; these helpers give
vren-compatible layouts to tools.  JAX computes in uint32; here the
values ride int64 masked to 32 bits after every product, which gives the
same bits.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value out to every 3rd bit."""
    v = v.to(torch.int64) & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def _compress_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _expand_bits: gather every 3rd bit into the low 10."""
    v = v.to(torch.int64) & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 as int32 (uint32 -> int32 wraps)."""
    v = v & _U32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int coords (each < 1024) -> (N,) int32 morton codes."""
    c = coords.to(torch.int64)
    code = (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2))
    return _as_int32(code)


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """(N,) morton codes -> (N, 3) int32 coords."""
    v = codes.to(torch.int64) & _U32
    return torch.stack([_compress_bits(v), _compress_bits(v >> 1),
                        _compress_bits(v >> 2)], -1).to(torch.int32)


def packbits(density_grid: torch.Tensor, threshold) -> torch.Tensor:
    """A flat grid -> uint8 bitfield, bit i of byte n set iff
    grid[8n+i] > threshold (vren's little-endian bits)."""
    bits = (density_grid.reshape(-1) > threshold).reshape(-1, 8)
    weights = 1 << torch.arange(8, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """Inverse of packbits -> flat bool of size 8*len(bitfield)."""
    b = bitfield.reshape(-1, 1).to(torch.int64)
    shifts = torch.arange(8, device=b.device)
    return ((b >> shifts) & 1).bool().reshape(-1)
