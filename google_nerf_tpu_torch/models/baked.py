"""Baked sparse-voxel field (port of google_nerf_tpu/models/baked.py).

The trained field is evaluated once onto a sparse pool of Bk^3-voxel
blocks.  Each pool row holds all 8 trilinear corners of one voxel
(8 corners x 16 features, corner-major, x = LSB of the corner index),
so a renderer reads one 256-byte bf16 row per sample.  `baked_field`
reads the field back with two lookups a sample (the block map, then the
voxel's row); `baked_apply` adds the live rgb MLP, so the baked field
can stand in for the live one in the one-shot and fast renderers
(`render_test_baked`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from google_nerf_tpu_torch.core.rays import norm3
from google_nerf_tpu_torch.models.encoders import sh_encode_deg4
from google_nerf_tpu_torch.models.mlp import mlp_apply
from google_nerf_tpu_torch.models.ngp import NGPConfig, ngp_density
from google_nerf_tpu_torch.ops.packed_hash import _corner_weights
from google_nerf_tpu_torch.ops.trunc_exp import trunc_exp


def baked_extent(cfg: NGPConfig) -> float:
    """Half-width of the baked grid: the cascade-0 bound min(0.5, scale)."""
    return min(0.5, cfg.scale)


@dataclasses.dataclass(frozen=True)
class BakedConfig:
    voxel_res: int = 512          # voxels per axis over [-scale, scale]
    block: int = 8                # voxels per block edge
    feat_dim: int = 16            # geo features per corner (h)
    dtype: str = "bfloat16"       # pool storage dtype

    @property
    def block_res(self) -> int:
        return self.voxel_res // self.block


def _occupied_blocks(occ0: np.ndarray, Gb: int) -> np.ndarray:
    """Block grid (Gb^3) of blocks overlapping a 1-cell-dilated occupied
    cell (dilation gives trilerp support at content boundaries)."""
    G = occ0.shape[0]
    occ_p = np.pad(occ0, 1)
    occ_d = np.zeros_like(occ0)
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                occ_d |= occ_p[dx:dx + G, dy:dy + G, dz:dz + G]
    if G >= Gb:
        f = G // Gb
        return occ_d.reshape(Gb, f, Gb, f, Gb, f).any((1, 3, 5))
    f = Gb // G
    return np.repeat(np.repeat(np.repeat(occ_d, f, 0), f, 1), f, 2)


@torch.no_grad()
def bake(params, cfg: NGPConfig, occ, bcfg: BakedConfig = BakedConfig(),
         chunk: int = 1048576, device="cuda"):
    """Evaluate the field onto a sparse voxel pool.

    occ: (C, G, G, G) bool occupancy (only cascade 0 is baked).  Returns
    dict block_map (Gb^3,) int32 (-1 = empty), pool (n_blocks * Bk^3,
    8 * feat_dim) in bcfg.dtype, rgb_mlp, n_blocks."""
    V, Bk, Gb, F = bcfg.voxel_res, bcfg.block, bcfg.block_res, bcfg.feat_dim
    occ0 = np.asarray(occ[0].cpu() if torch.is_tensor(occ) else occ[0],
                      dtype=bool)
    G = occ0.shape[0]
    s = baked_extent(cfg)
    blk_occ = _occupied_blocks(occ0, Gb)
    blk_ids = np.flatnonzero(blk_occ.reshape(-1)).astype(np.int64)
    n_blocks = int(blk_ids.size)
    block_map = np.full((Gb ** 3,), -1, np.int32)
    block_map[blk_ids] = np.arange(n_blocks, dtype=np.int32)

    origin = np.stack([blk_ids // (Gb * Gb), (blk_ids // Gb) % Gb,
                       blk_ids % Gb], -1) * Bk                # (n, 3)
    origin = torch.as_tensor(origin, device=device)
    ar = lambda n: torch.arange(n, device=device)              # noqa: E731
    cgrid = torch.stack(torch.meshgrid(ar(Bk + 1), ar(Bk + 1), ar(Bk + 1),
                                       indexing="ij"), -1).reshape(-1, 3)
    voxoff = torch.stack(torch.meshgrid(ar(Bk), ar(Bk), ar(Bk),
                                        indexing="ij"), -1).reshape(-1, 3)
    occ0_dev = torch.as_tensor(occ0, device=device)
    params = {k: ([w.to(device) for w in v] if isinstance(v, list)
                  else v.to(device)) for k, v in params.items()}
    pool_dtype = getattr(torch, bcfg.dtype)
    blocks_per_chunk = max(chunk // (Bk + 1) ** 3, 1)
    pool = torch.empty((n_blocks * Bk ** 3, 8 * F), dtype=pool_dtype,
                       device=device)
    for i in range(0, n_blocks, blocks_per_chunk):
        orig = origin[i:i + blocks_per_chunk]
        nb = orig.shape[0]
        pts = orig[:, None, :] + cgrid[None]                  # (nb, n_cg, 3)
        xyz = (pts.float() / V * 2.0 - 1.0) * s
        feats = ngp_density(params, cfg, xyz.reshape(-1, 3),
                            return_feat=True)[1]
        Cg = feats.reshape(nb, Bk + 1, Bk + 1, Bk + 1, F)
        # voxel (i,j,k) corner c (bits x=LSB, y, z) = Cg[i+ox, j+oy, k+oz]
        rows = torch.stack([
            Cg[:, ox:ox + Bk, oy:oy + Bk, oz:oz + Bk]
            for c in range(8)
            for ox, oy, oz in [((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1)]
        ], dim=4).reshape(nb, Bk ** 3, 8, F)
        # gate sigma (pre-activation -30) in voxels whose UNDILATED
        # occupancy cell is empty: the brick renderers integrate every
        # in-brick sample, unlike the occupancy marchers
        gv = orig[:, None, :] + voxoff[None]                  # (nb, Bk^3, 3)
        cell = torch.clamp((gv * G) // V, 0, G - 1)
        m = occ0_dev[cell[..., 0], cell[..., 1], cell[..., 2]]
        rows[..., 0] = torch.where(m[..., None], rows[..., 0], -30.0)
        pool[i * Bk ** 3:(i + nb) * Bk ** 3] = \
            rows.reshape(nb * Bk ** 3, 8 * F).to(pool_dtype)
    return dict(block_map=torch.as_tensor(block_map, device=device),
                pool=pool, rgb_mlp=[w.detach() for w in params["rgb_mlp"]],
                n_blocks=n_blocks)


def trilerp_w8(frac):
    """Trilinear corner weights (..., 8) from in-voxel fractions (..., 3);
    corner c's offset on axis k is bit k of c (x = LSB), the packed hash
    table's corner order."""
    return _corner_weights(frac)


def trilerp_rows(rows, frac, compute_dtype=torch.bfloat16):
    """h (N, F) f32 from pool rows (N, 8F) and in-voxel fractions (N, 3)
    at JAX's rounding points: frac, the corner weights and the rows in
    compute_dtype, the 8-corner sum accumulated in f32 and rounded to
    compute_dtype, then widened."""
    w = trilerp_w8(frac.to(compute_dtype)).float()            # (N, 8)
    r = rows.to(compute_dtype).reshape(rows.shape[0], 8, -1)
    h = w[:, 0, None] * r[:, 0].float()
    for c in range(1, 8):
        h = h + w[:, c, None] * r[:, c].float()
    return h.to(compute_dtype).float()


def _voxel_coords(x, s: float, V: int):
    """World x (..., 3) -> (v0 int64 voxel, frac f32) on the V^3 lattice
    over [-s, s]; x / s is a true division (see ops/grid._div)."""
    pos = torch.clamp(x / torch.full((), s, dtype=x.dtype, device=x.device)
                      * 0.5 + 0.5, 0.0, 1.0 - 1e-6) * V
    v0 = torch.floor(pos)
    return v0.long(), pos - v0


def baked_field(baked, cfg: NGPConfig, bcfg: BakedConfig, x,
                compute_dtype=torch.bfloat16):
    """x: (N, 3) world -> (sigmas (N,), h (N, F)) through the block map
    and one pool row a sample; samples in empty blocks get sigma 0."""
    V, Bk, Gb = bcfg.voxel_res, bcfg.block, bcfg.block_res
    v0, frac = _voxel_coords(x, baked_extent(cfg), V)
    b = torch.div(v0, Bk, rounding_mode="floor")
    pb = baked["block_map"][(b[:, 0] * Gb + b[:, 1]) * Gb + b[:, 2]].long()
    local = v0 - b * Bk
    lid = (local[:, 0] * Bk + local[:, 1]) * Bk + local[:, 2]
    rows = baked["pool"][torch.where(pb >= 0, pb * Bk ** 3 + lid, 0)]
    h = trilerp_rows(rows, frac, compute_dtype)
    return torch.where(pb >= 0, trunc_exp(h[:, 0]), 0.0), h


def baked_apply(baked, cfg: NGPConfig, bcfg: BakedConfig, x, d):
    """The baked field with the live rgb head: (sigmas, rgbs) as
    ngp_apply gives them."""
    sig, h = baked_field(baked, cfg, bcfg, x)
    d = d / norm3(d, keepdim=True)
    logits = mlp_apply(baked["rgb_mlp"], torch.cat([sh_encode_deg4(d), h], -1),
                       compute_dtype=torch.bfloat16)
    return sig, torch.sigmoid(logits)


def make_baked_apply(bcfg: BakedConfig):
    """apply_fn(baked, cfg, x, d) for the one-shot and fast renderers."""
    def apply_fn(params, cfg, x, d):
        return baked_apply(params, cfg, bcfg, x, d)
    return apply_fn


def render_test_baked(baked, cfg: NGPConfig, occ_u8, rays_o, rays_d,
                      bcfg: BakedConfig = BakedConfig(), **kw):
    """render_test_fast over the baked field (its keywords in kw)."""
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    return render_test_fast(baked, cfg, occ_u8, rays_o, rays_d,
                            apply_fn=make_baked_apply(bcfg), **kw)


def save_baked(path: str, baked, bcfg: BakedConfig):
    """Write the bake as one .npz in the JAX save_baked layout.  A bf16
    pool travels as its raw 2-byte values (uint16 bits), as ml_dtypes
    arrays do in the JAX writer, so either side loads the other's file."""
    pool = baked["pool"].detach().cpu()
    if pool.dtype == torch.bfloat16:
        pool_np = pool.view(torch.int16).numpy().view(np.uint16)
    else:
        pool_np = pool.numpy()
    np.savez_compressed(
        path,
        block_map=baked["block_map"].cpu().numpy(),
        pool=pool_np,
        pool_dtype=str(bcfg.dtype),
        n_blocks=int(baked["n_blocks"]),
        voxel_res=bcfg.voxel_res, block=bcfg.block, feat_dim=bcfg.feat_dim,
        **{f"rgb_mlp_{i}": w.detach().cpu().numpy()
           for i, w in enumerate(baked["rgb_mlp"])})


def load_baked(path: str, device="cuda"):
    """Load a save_baked artifact (JAX's or the port's) -> (baked, bcfg)."""
    with np.load(path) as z:
        dtype = str(z["pool_dtype"])
        raw = z["pool"]
        if dtype == "bfloat16":
            pool = torch.from_numpy(
                np.ascontiguousarray(raw).view(np.uint16).view(np.int16)
            ).view(torch.bfloat16)
        else:
            pool = torch.from_numpy(raw.astype(np.dtype(dtype)))
        n_mlp = len([k for k in z.files if k.startswith("rgb_mlp_")])
        baked = dict(
            block_map=torch.as_tensor(z["block_map"], device=device),
            pool=pool.to(device),
            rgb_mlp=[torch.as_tensor(z[f"rgb_mlp_{i}"], device=device)
                     for i in range(n_mlp)],
            n_blocks=int(z["n_blocks"]))
        bcfg = BakedConfig(voxel_res=int(z["voxel_res"]),
                           block=int(z["block"]),
                           feat_dim=int(z["feat_dim"]), dtype=dtype)
    return baked, bcfg
