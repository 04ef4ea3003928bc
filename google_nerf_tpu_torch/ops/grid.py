"""Occupancy/density-grid maintenance (port of google_nerf_tpu/ops/grid.py).

The density grid is raster (C, G, G, G) float32, index [c, x, y, z];
negative cells are permanently invisible.  Occupancy is `grid >
threshold` as a bool array; the block marcher reads it packed into
per-cell 8^3 block rows (pack_occupancy_blocks), the block2 marcher into
two int32 tables (pack_occupancy_blocks4, pack_super_liveness).  Cell
centers follow the reference mapping

    world(c, i) = (i / (G-1) * 2 - 1) * (s - s/G),  s = min(2^(c-1), scale).

Random draws come from a torch.Generator or from the caller (`draws`),
so tests can hand in the draws JAX made from its key.  The density
evaluation of an update can be sharded over a process group (JAX's
`axis_name`): every rank takes the same draws, evaluates its share of
the fixed-shape chunks, and the per-cell maxima are merged by an
all-reduce with MAX (parallel/dp.make_dp_grid_update).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from google_nerf_tpu_torch.parallel import comm

NEAR_DISTANCE = 0.05


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true division: on the card a Python-float divisor
    becomes a multiply by its reciprocal, which can differ in the last
    bit from JAX's division."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def cell_coords(grid_size: int, device="cuda") -> torch.Tensor:
    """(G^3, 3) int32 raster-order cell coordinates."""
    g = torch.arange(grid_size, dtype=torch.int32, device=device)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([x, y, z], -1).reshape(-1, 3)


def _cascade_bound(c: int, scale: float) -> float:
    return min(2.0 ** (c - 1), scale)


def cells_to_world(coords, cascade: int, scale: float, grid_size: int):
    """Cell integer coords -> world-space cell centers for one cascade."""
    s = _cascade_bound(cascade, scale)
    half = s / grid_size
    return (_div(coords.to(torch.float32), grid_size - 1) * 2 - 1) * (s - half)


@torch.no_grad()
def mark_invisible_cells(K, poses, *, img_w: int, img_h: int, grid_size: int,
                         cascades: int, scale: float, device="cuda",
                         n_chunks: int = 32):
    """Initial density grid: 0 for camera-covered cells, -1 for invisible
    or too-near cells (they stay dead forever).

    K: (3, 3); poses: (N, 3, 4) c2w.  Returns (C, G, G, G) float32.  The
    camera products are fp32 elementwise multiply-adds (JAX asks for
    Precision.HIGHEST)."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    w2c_R = poses[:, :3, :3].transpose(1, 2)                  # (N, 3, 3)
    w2c_T = -(w2c_R * poses[:, None, :3, 3]).sum(-1)          # (N, 3)
    coords = cell_coords(grid_size, device)
    grids = []
    for c in range(cascades):
        xyz_w = cells_to_world(coords, c, scale, grid_size)
        vals = []
        for chunk in xyz_w.reshape(n_chunks, -1, 3):
            xyz_c = ((w2c_R[:, None] * chunk[None, :, None, :]).sum(-1)
                     + w2c_T[:, None, :])                     # (N, M, 3)
            uvd = (K * xyz_c[..., None, :]).sum(-1)
            z = uvd[..., 2]
            zs = torch.where(z.abs() > 1e-9, z, 1e-9)[..., None]
            uv = uvd[..., :2] / zs
            in_image = ((z >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                        & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
            covered = ((z >= NEAR_DISTANCE) & in_image).any(0)
            too_near = ((z < NEAR_DISTANCE) & in_image).any(0)
            vals.append(torch.where(covered & ~too_near, 0.0, -1.0))
        grids.append(torch.cat(vals))
    return torch.stack(grids).reshape((cascades,) + (grid_size,) * 3)


def _sample_occupied(u, rand_idx, occ_flat):
    """m cell indices ~ uniform over True entries of occ_flat (G^3,),
    from uniforms u (m,) in [0, 1); rand_idx (m,) where nothing is
    occupied."""
    cnt = occ_flat.sum(dtype=torch.int32)
    cs = torch.cumsum(occ_flat.to(torch.int32), 0, dtype=torch.int32)
    pick = (u * torch.clamp_min(cnt, 1).to(u.dtype)).to(torch.int32) + 1
    idx = torch.searchsorted(cs, pick, side="left").clamp(
        0, occ_flat.shape[0] - 1).to(torch.int32)
    return torch.where(cnt > 0, idx, rand_idx.to(torch.int32))


def _segment_max_dense(idx, vals, n: int):
    """Per-cell maximum of `vals` grouped by cell index, floored at 0 (a
    max is exact in any order)."""
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx.long(), vals, "amax", include_self=True)


def _erode(grid):
    """Cells that are a positive local max of their 3x3x3 neighborhood
    (the reference's floater killer)."""
    mp = F.max_pool3d(grid, 3, stride=1, padding=1)
    return (grid == mp) & (mp > 0)


def grid_draws(G: int, cascades: int, *, warmup: bool, sample_div: int,
               generator=None, device="cuda"):
    """The random draws of one update: per cascade, the sampled cells'
    uniform coords (m, 3) int32, the occupied cells' uniforms u (m,) and
    fallback cells rand_idx (m,) (sampled updates only), and the jitter
    uniforms (n, 3) in [0, 1)."""
    out = []
    for _ in range(cascades):
        d = {}
        n = G ** 3
        if not warmup:
            m = G ** 3 // sample_div
            kw = dict(generator=generator, device=device)
            d["coords_u"] = torch.randint(0, G, (m, 3), dtype=torch.int32,
                                          **kw)
            d["u"] = torch.rand(m, **kw)
            d["rand_idx"] = torch.randint(0, G ** 3, (m,), dtype=torch.int32,
                                          **kw)
            n = 2 * m
        d["jitter"] = torch.rand((n, 3), generator=generator, device=device)
        out.append(d)
    return out


@torch.no_grad()
def update_density_grid(density_grid, density_fn, *, scale: float,
                        density_threshold: float, warmup: bool,
                        decay: float = 0.95, erode: bool = False,
                        eval_chunks: int = 32, sample_div: int = 4,
                        generator=None, draws=None, sharded: bool = False,
                        group=None):
    """One density-grid maintenance step.

    density_grid: (C, G, G, G) float32; density_fn: (M, 3) world xyz ->
    (M,) sigma.  Warmup evaluates every cell, otherwise G^3/sample_div
    uniform and as many occupied cells per cascade.  draws: grid_draws'
    list (made from `generator` when None).  Returns (new_density_grid,
    occ bool (C, G, G, G)).

    The sampled cells are evaluated in `eval_chunks` chunks of one shape,
    which depends on (G, warmup) only.  With `sharded`, the ranks of
    `group` (which must all pass the same draws) each evaluate a
    contiguous eval_chunks // world of them, and the per-cell maxima are
    merged by an all-reduce with MAX.  A max is exact in any order and
    each chunk sees the shape it has in the serial update, so the merged
    grid equals the serial one bit for bit."""
    C, G = density_grid.shape[0], density_grid.shape[1]
    dev = density_grid.device
    if draws is None:
        draws = grid_draws(G, C, warmup=warmup, sample_div=sample_div,
                           generator=generator, device=dev)
    flat = density_grid.reshape(C, -1)
    tmp = torch.zeros_like(flat)
    n_rep = comm.get_world_size(group) if sharded else 1
    rep = comm.get_rank(group) if sharded else 0
    if eval_chunks % n_rep:
        raise ValueError(f"eval_chunks={eval_chunks} must be a multiple of "
                         f"the world size {n_rep}")
    vg = eval_chunks // n_rep                # chunks this rank evaluates
    for c in range(C):
        d = draws[c]
        if warmup:
            idx = torch.arange(G ** 3, dtype=torch.int32, device=dev)
        else:
            cu = d["coords_u"]
            idx_u = (cu[:, 0] * G + cu[:, 1]) * G + cu[:, 2]
            idx_o = _sample_occupied(d["u"], d["rand_idx"], flat[c] > 0)
            idx = torch.cat([idx_u, idx_o])
        coords = torch.stack([torch.div(idx, G * G, rounding_mode="floor"),
                              torch.div(idx, G, rounding_mode="floor") % G,
                              idx % G], -1)
        xyz = cells_to_world(coords, c, scale, G)
        half = _cascade_bound(c, scale) / G
        pts = xyz + (d["jitter"] * 2 - 1) * half
        if idx.shape[0] % eval_chunks:
            raise ValueError(f"eval_chunks={eval_chunks} must divide the "
                             f"sample count {idx.shape[0]}")
        idx = idx.reshape(eval_chunks, -1)[rep * vg:(rep + 1) * vg]
        pts = pts.reshape(eval_chunks, -1, 3)[rep * vg:(rep + 1) * vg]
        sigmas = torch.cat([density_fn(p).reshape(-1) for p in pts])
        tmp[c] = _segment_max_dense(idx.reshape(-1), sigmas.float(), G ** 3)
    if sharded and comm.initialized():
        # a group of one still takes the all-reduce: its backend's path
        dist.all_reduce(tmp, op=dist.ReduceOp.MAX, group=group)
    new = torch.where(flat < 0, flat, torch.maximum(flat * decay, tmp))
    new = new.reshape(density_grid.shape)
    if erode:
        new = torch.where(_erode(new), new * decay, new)
    pos = new > 0
    mean_density = torch.where(pos, new, 0.0).sum() / torch.clamp_min(
        pos.sum(), 1).to(new.dtype)
    occ = new > torch.clamp_max(mean_density, density_threshold)
    return new, occ


def pack_occupancy_blocks(occ, block: int = 8) -> torch.Tensor:
    """occ: (1, G, G, G) bool -> (G^3, 16) int32 exact-occupancy block
    rows for the one-phase block marcher.  Row m (the raster index of the
    anchor cell) holds the forward 8^3 block: bit o = dx*64 + dy*8 + dz of
    word o // 32 is occ[anchor + (dx, dy, dz)], (dx, dy, dz) in {0..7}^3
    (out-of-grid = 0).  Built from 8 z-shifted ORs (the byte of 8 z bits)
    and 64 xy-shifted ORs."""
    assert occ.shape[0] == 1, "block rows are single-cascade only"
    assert block == 8, "only 8^3 (512-bit, 16-word) blocks are implemented"
    G = occ.shape[1]
    padded = F.pad(occ[0].to(torch.int32), (0, 7, 0, 7, 0, 7))
    # zb[x, y, z] = bits dz of occ[x, y, z + dz], dz in {0..7}
    zb = padded[:, :, 0:G]
    for dz in range(1, 8):
        zb = zb | (padded[:, :, dz:dz + G] << dz)
    words = []
    for w in range(16):
        dx = w // 2
        acc = None
        for sub in range(4):
            dy = (w % 2) * 4 + sub
            t = zb[dx:dx + G, dy:dy + G, :] << (8 * sub)
            acc = t if acc is None else acc | t
        words.append(acc)
    return torch.stack(words, -1).reshape(G * G * G, 16)


def pack_occupancy_blocks4(occ, stride: int = 4) -> torch.Tensor:
    """((G//stride)^3, 16) int32 stride-anchored 8^3 block rows for the
    block2 marcher.  Row a (raster index over the anchor lattice) holds
    the exact occupancy of cells [stride*a .. stride*a + 7] per axis: bit
    o = dx*64 + dy*8 + dz of word o // 32 is occ[anchor + (dx, dy, dz)]
    (out-of-grid = 0).  Built at the anchors only (JAX builds the
    per-cell table and takes every stride-th row: the same words)."""
    assert occ.shape[0] == 1, "block rows are single-cascade only"
    G = occ.shape[1]
    assert G % stride == 0
    padded = F.pad(occ[0].to(torch.int32), (0, 7, 0, 7, 0, 7))
    # zb[x, y, z] = bits dz of occ[x, y, z + dz], dz in {0..7}
    zb = padded[:, :, 0:G]
    for dz in range(1, 8):
        zb = zb | (padded[:, :, dz:dz + G] << dz)
    zb = zb[:, :, 0:G:stride]
    words = []
    for w in range(16):
        dx = w // 2
        acc = None
        for sub in range(4):
            dy = (w % 2) * 4 + sub
            t = zb[dx:dx + G:stride, dy:dy + G:stride, :] << (8 * sub)
            acc = t if acc is None else acc | t
        words.append(acc)
    return torch.stack(words, -1).reshape(-1, 16)


def pack_super_liveness(occ, window: int, stride: int = 8) -> torch.Tensor:
    """((G//stride)^3,) int32 forward-window liveness: entry a is 1 iff
    any cell in [stride*a .. stride*a + window - 1]^3 is occupied.  The
    window OR is separable: one max pass per axis."""
    assert occ.shape[0] == 1, "super liveness is single-cascade only"
    G = occ.shape[1]
    assert G % stride == 0
    x = F.pad(occ.to(torch.float32), (0, window - 1) * 3)[None]
    for k, s in (((window, 1, 1), (stride, 1, 1)),
                 ((1, window, 1), (1, stride, 1)),
                 ((1, 1, window), (1, 1, stride))):
        x = F.max_pool3d(x, k, stride=s)
    return (x[0, 0] > 0).to(torch.int32).reshape(-1)


def pack_occupancy_u8(occ, dilation_radius: int = 2,
                      super_radius: int = 0) -> torch.Tensor:
    """occ: (C, G, G, G) bool -> (C, G, G, G) int32 word grid for the
    segment marcher (ops/march_seg.py).  Per-cell bits:

      bit 0        occupied (this cell)
      bit 1        occupied within Chebyshev radius `dilation_radius`
      bit 2        occupied within `super_radius` (only when > 0)
      bits 3..29   the 3x3x3 FORWARD block: bit 3 + dx*9 + dy*3 + dz =
                   occ[cell + (dx, dy, dz)], (dx, dy, dz) in {0, 1, 2}^3,
                   out-of-grid = 0.

    The name is JAX's (the layout was uint8 before the block bits)."""
    occ = occ.to(torch.int32)
    G = occ.shape[1]

    def dilate(r):
        # Chebyshev dilation is separable: one OR window per axis
        out = occ
        for axis in (1, 2, 3):
            pad = [0, 0] * 3
            pad[2 * (3 - axis)] = pad[2 * (3 - axis) + 1] = r
            p = F.pad(out, pad)
            acc = torch.zeros_like(out)
            for s in range(2 * r + 1):
                acc = acc | p.narrow(axis, s, G)
            out = acc
        return out

    out = occ | (dilate(dilation_radius) << 1)
    if super_radius > 0:
        out = out | (dilate(super_radius) << 2)
    padded = F.pad(occ, (0, 2, 0, 2, 0, 2))
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                blk = padded[:, dx:dx + G, dy:dy + G, dz:dz + G]
                out = out | (blk << (3 + dx * 9 + dy * 3 + dz))
    return out
