"""Per-frame pre-shaded RGBA pool (port of
google_nerf_tpu/models/baked_rgba.py).

The rgb MLP runs once per voxel corner per frame, with each grid point's
own view direction from the camera origin, and the per-corner [log sigma,
r, g, b] are packed into (n_blocks, 32, Bk^3) slabs for K5
(`brick_field_tiles_rgba`): 4x fewer slab bytes than the feature pool and
no MLP in the kernel.  This computes trilerp(MLP(h)) where the live
renderer computes MLP(trilerp(h)): the baked-shading approximation.  The
bake belongs to the frame, and its time is part of the frame's.

The MLP runs on the (Bk+1)^3 corner grid of each block, rebuilt from the
corner-replicated pool rows by slicing (shared corners are identical by
construction, models/baked.bake).
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import BakedConfig, baked_extent
from google_nerf_tpu_torch.models.encoders import sh_encode_deg4
from google_nerf_tpu_torch.models.mlp import mlp_apply
from google_nerf_tpu_torch.models.ngp import NGPConfig


def _corner_grid(pool_rows, Bk, F):
    """(nb, Bk^3, 8F) corner-replicated rows -> (nb, Bk+1, Bk+1, Bk+1, F)
    corner grid (any replica represents its shared corner)."""
    nb = pool_rows.shape[0]
    # corner c = cx + 2 cy + 4 cz (x = LSB): the 8-corner axis reshaped to
    # (2, 2, 2) is (cz, cy, cx)
    p = pool_rows.reshape(nb, Bk, Bk, Bk, 2, 2, 2, F)
    gx = torch.cat([p[:, :, :, :, :, :, 0, :],
                    p[:, Bk - 1:, :, :, :, :, 1, :]], dim=1)
    gy = torch.cat([gx[:, :, :, :, :, 0, :],
                    gx[:, :, Bk - 1:, :, :, 1, :]], dim=2)
    return torch.cat([gy[:, :, :, :, 0, :],
                      gy[:, :, :, Bk - 1:, 1, :]], dim=3)


def _rows_from_grid(G, Bk):
    """(nb, Bk+1, Bk+1, Bk+1, C) -> (nb, Bk^3, 8, C) per-voxel corner rows
    (the bake()'s slicing; corner c bit k = offset on axis k, x = LSB)."""
    nb, C = G.shape[0], G.shape[-1]
    rows = torch.stack([
        G[:, ox:ox + Bk, oy:oy + Bk, oz:oz + Bk]
        for c in range(8)
        for ox, oy, oz in [((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1)]
    ], dim=4)
    return rows.reshape(nb, Bk ** 3, 8, C)


def _bake_rgba_chunk(pool_rows, origins, rgb_mlp, cam_o, *, Bk, F, V, s,
                     out_dtype):
    """pool_rows (nb, Bk^3, 8F) in the pool's own dtype; origins (nb, 3)
    voxel coordinates of each block's min corner -> (nb, 32, Bk^3)."""
    nb = pool_rows.shape[0]
    n_cg = (Bk + 1) ** 3
    h = _corner_grid(pool_rows, Bk, F).reshape(nb, n_cg, F) \
        .to(torch.bfloat16)
    ar = torch.arange(Bk + 1, device=pool_rows.device)
    cg = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                     -1).reshape(-1, 3)
    pts = origins[:, None, :] + cg[None]                   # grid points
    xyz = (pts.float() / V * 2.0 - 1.0) * s
    d = xyz - cam_o[None, None, :]
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True),
                            1e-8)
    sh = sh_encode_deg4(d.reshape(-1, 3)).to(torch.bfloat16)
    rgb_in = torch.cat([sh, h.reshape(-1, F)], dim=-1)
    logits = mlp_apply(rgb_mlp, rgb_in, compute_dtype=torch.bfloat16)
    rgb = torch.sigmoid(logits).reshape(nb, n_cg, 3)
    rgba = torch.cat([h[..., 0:1].float(), rgb], dim=-1)   # (nb, n_cg, 4)
    rows = _rows_from_grid(rgba.reshape(nb, Bk + 1, Bk + 1, Bk + 1, 4), Bk)
    return rows.reshape(nb, Bk ** 3, 32).transpose(1, 2).to(out_dtype)


@torch.no_grad()
def bake_rgba(baked, cfg: NGPConfig, bcfg: BakedConfig, cam_o,
              dtype: str = "bfloat16", chunk_blocks: int = 4096):
    """Pre-shade the baked pool for one camera origin: (n_blocks, 32,
    Bk^3) slabs for brick_field_tiles_rgba, on the pool's device.  Run it
    once per frame (its time is part of the frame)."""
    Bk, V, F = bcfg.block, bcfg.voxel_res, bcfg.feat_dim
    nb = int(baked["n_blocks"])
    pool = baked["pool"]                       # (nb * Bk^3, 8F)
    dev = pool.device
    bm = baked["block_map"]
    bm = bm.cpu().numpy() if torch.is_tensor(bm) else np.asarray(bm)
    Gb = bcfg.block_res
    blk_ids = np.argsort(bm, kind="stable")[-nb:]          # pool order
    origins = torch.as_tensor(
        np.stack([blk_ids // (Gb * Gb), (blk_ids // Gb) % Gb, blk_ids % Gb],
                 -1).astype(np.int64) * Bk, device=dev)
    cam_o = torch.as_tensor(cam_o, dtype=torch.float32,
                            device=dev).reshape(3)
    rgb_mlp = [w.to(dev) for w in baked["rgb_mlp"]]
    out_dtype = getattr(torch, dtype)
    rpb = Bk ** 3
    out = torch.empty((nb, 32, rpb), dtype=out_dtype, device=dev)
    for i in range(0, nb, chunk_blocks):
        n = min(chunk_blocks, nb - i)
        out[i:i + n] = _bake_rgba_chunk(
            pool[i * rpb:(i + n) * rpb].reshape(n, rpb, 8 * F),
            origins[i:i + n], rgb_mlp, cam_o, Bk=Bk, F=F, V=V,
            s=baked_extent(cfg), out_dtype=out_dtype)
    return out


def render_brick_mxu_rgba(baked, cfg: NGPConfig, rays_o, rays_d, W, H, *,
                          bcfg: BakedConfig, cam_o=None,
                          rgba_dtype: str = "bfloat16", device="cuda", **kw):
    """Pre-shade for this frame's camera origin (default rays_o[0], a
    pinhole), then render with K5 (render_brick_mxu kernel="rgba").  The
    bake runs inside the frame.  Other keywords as render_brick_mxu."""
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    if cam_o is None:
        cam_o = torch.as_tensor(rays_o)[0]
    pooled = dict(baked, pool=baked["pool"].to(device),
                  rgb_mlp=[w.to(device) for w in baked["rgb_mlp"]])
    baked["poolRGBA"] = bake_rgba(pooled, cfg, bcfg, cam_o,
                                  dtype=rgba_dtype)
    return render_brick_mxu(baked, cfg, rays_o, rays_d, W, H, bcfg=bcfg,
                            kernel="rgba", device=device, **kw)
