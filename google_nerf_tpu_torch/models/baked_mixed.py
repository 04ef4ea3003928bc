"""Mixed-resolution baked brick field (port of
google_nerf_tpu/models/baked_mixed.py).

Bake the field at two resolutions, one octave apart; probe both baked
fields at every fine brick's voxel centers; a coarse brick replaces its
(up to 8) fine children iff every existing child's sigma and feature
deviations stay within tolerance.  The result is one pool and one (lo,
hi) geometry of mixed-size bricks, which the brick renderers take as
they are: each brick's lattice comes from its own AABB.

The pool is assembled on the device in a sequence that bounds peak
memory: any cached `poolT`/`poolRGBA` of the inputs is dropped first,
then the coarse rows are taken and the coarse pool dropped, then the
fine rows and the fine pool.  Callers pass owning references.
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import BakedConfig, bake, baked_field
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_brick import brick_geometry


def _fine_brick_errors(fine, coarse, cfg: NGPConfig, bcf: BakedConfig,
                       bcc: BakedConfig, lof, hif, chunk_bricks: int = 2048):
    """Per fine brick: max |sigma_c - sigma_f| and max |h_c - h_f| (h
    channels 1:, the rgb MLP's inputs) over its Bk^3 voxel centers.
    Returns (err_sig (Nf,), err_feat (Nf,)) numpy."""
    Bk = bcf.block
    cg = torch.arange(Bk, dtype=torch.float32, device=lof.device) + 0.5
    grid = torch.stack(torch.meshgrid(cg, cg, cg, indexing="ij"),
                       -1).reshape(-1, 3) / Bk            # in brick units
    es_all, ef_all = [], []
    for i in range(0, lof.shape[0], chunk_bricks):
        lo_c, hi_c = lof[i:i + chunk_bricks], hif[i:i + chunk_bricks]
        pts = (lo_c[:, None, :]
               + grid[None] * (hi_c - lo_c)[:, None, :]).reshape(-1, 3)
        sf, hf = baked_field(fine, cfg, bcf, pts)
        sc, hc = baked_field(coarse, cfg, bcc, pts)
        es_all.append((sc - sf).abs().reshape(-1, Bk ** 3).amax(1).cpu())
        ef_all.append((hc[:, 1:] - hf[:, 1:]).abs().amax(-1)
                      .reshape(-1, Bk ** 3).amax(1).cpu())
    return torch.cat(es_all).numpy(), torch.cat(ef_all).numpy()


def bake_mixed(params, cfg: NGPConfig, occ, *, vres_fine: int = 512,
               vres_coarse: int = 256, block: int = 8,
               dtype: str = "bfloat16", tol_sigma: float = 2.0,
               tol_feat: float = 0.25, fine=None, coarse=None,
               device="cuda"):
    """Bake a mixed-resolution brick field, JAX's arguments.

    tol_sigma: max |sigma| deviation; tol_feat: max deviation of the 15
    rgb-MLP feature channels; tol_* <= 0 disables merging.  fine/coarse:
    bakes the caller already holds (their pools are consumed).

    Returns (baked, bcfg, geometry, stats): baked = dict(pool (Nm*Bk^3,
    8F), rgb_mlp, n_blocks), brick i's slab at rows [i*Bk^3, (i+1)*Bk^3);
    bcfg at the coarse resolution (the widest brick sizes the renderer's
    window span); geometry = (lo, hi, pool_base); stats = dict(
    n_fine_total, n_fine_kept, n_coarse, bricks_saved_frac, err_pct)."""
    if not (vres_fine % vres_coarse == 0 and vres_fine // vres_coarse == 2):
        raise ValueError("one octave per merge step (fine = 2 x coarse)")
    bcf = BakedConfig(voxel_res=vres_fine, block=block, dtype=dtype)
    bcc = BakedConfig(voxel_res=vres_coarse, block=block, dtype=dtype)
    if fine is None:
        fine = bake(params, cfg, occ, bcf, device=device)
    if coarse is None:
        coarse = bake(params, cfg, occ, bcc, device=device)
    for b in (fine, coarse):            # cached layouts of the inputs
        b.pop("poolT", None)
        b.pop("poolRGBA", None)
    lof, hif, _ = brick_geometry(fine["block_map"], bcf, cfg, device)
    loc, hic, _ = brick_geometry(coarse["block_map"], bcc, cfg, device)
    Nf, Nc = lof.shape[0], loc.shape[0]
    vox = block ** 3

    merge = np.zeros((Nf,), bool)
    sel_c = np.zeros((0,), np.int64)
    err_pct = None
    if tol_sigma > 0 and tol_feat > 0 and Nc:
        es, ef = _fine_brick_errors(fine, coarse, cfg, bcf, bcc, lof, hif)
        ok_f = (es <= tol_sigma) & (ef <= tol_feat)          # (Nf,)
        q = [10, 25, 50, 75, 90]
        err_pct = dict(sigma=[round(float(v), 3)
                              for v in np.percentile(es, q)],
                       feat=[round(float(v), 3)
                             for v in np.percentile(ef, q)])
        # fine brick -> parent coarse brick, pool order on both sides
        Gbf, Gbc = bcf.block_res, bcc.block_res
        bmf = fine["block_map"].cpu().numpy()
        bmc = coarse["block_map"].cpu().numpy()
        fin_ids = np.flatnonzero(bmf >= 0)
        fin_ids = fin_ids[np.argsort(bmf[fin_ids])]          # pool order
        fx, fy, fz = (fin_ids // (Gbf * Gbf), (fin_ids // Gbf) % Gbf,
                      fin_ids % Gbf)
        parent_pool = bmc[((fx // 2) * Gbc + (fy // 2)) * Gbc + (fz // 2)]
        # a coarse brick merges iff it exists and ALL its existing fine
        # children pass both tolerances
        ok_per_c = np.ones((Nc,), bool)
        has_child = np.zeros((Nc,), bool)
        valid = parent_pool >= 0
        np.logical_and.at(ok_per_c, parent_pool[valid], ok_f[valid])
        has_child[parent_pool[valid]] = True
        mergeable_c = ok_per_c & has_child
        merge = valid & mergeable_c[np.clip(parent_pool, 0, Nc - 1)]
        sel_c = np.flatnonzero(mergeable_c)

    sel_f = torch.as_tensor(np.flatnonzero(~merge), device=device)
    sel_c_t = torch.as_tensor(sel_c, device=device)
    lo = torch.cat([lof[sel_f], loc[sel_c_t]])
    hi = torch.cat([hif[sel_f], hic[sel_c_t]])
    cpart = coarse.pop("pool").reshape(Nc, -1)[sel_c_t] if len(sel_c) \
        else None
    coarse.pop("pool", None)
    fpart = fine.pop("pool").reshape(Nf, -1)[sel_f]
    pool = torch.cat([fpart, cpart]) if cpart is not None else fpart
    del fpart, cpart
    n_blocks = int(pool.shape[0])
    baked = dict(pool=pool.reshape(n_blocks * vox, -1),
                 rgb_mlp=fine["rgb_mlp"], n_blocks=n_blocks)
    pool_base = torch.arange(n_blocks, dtype=torch.int32,
                             device=device) * vox
    stats = dict(n_fine_total=int(Nf), n_fine_kept=int(sel_f.numel()),
                 n_coarse=int(len(sel_c)),
                 bricks_saved_frac=round(1.0 - n_blocks / max(Nf, 1), 3),
                 err_pct=err_pct)
    return baked, bcc, (lo, hi, pool_base), stats


def pad_bricks(baked, geo, mult: int = 4096):
    """Pad the brick count to a multiple of `mult` with far-away bricks
    that no cone cull keeps (zero pool rows, AABBs at 1e6), as JAX does
    to share one compiled frame between brick counts."""
    lo, hi, _ = geo
    n = baked["n_blocks"]
    vox = baked["pool"].shape[0] // n
    npad = (-n) % mult
    if npad == 0:
        return baked, geo
    pool = torch.cat([baked["pool"], baked["pool"].new_zeros(
        (npad * vox, baked["pool"].shape[1]))])
    far = torch.full((npad, 3), 1e6, dtype=lo.dtype, device=lo.device)
    geo2 = (torch.cat([lo, far]), torch.cat([hi, far + 1e-3]),
            torch.arange(n + npad, dtype=torch.int32, device=lo.device) * vox)
    b2 = dict(baked)
    b2["pool"] = pool
    b2["n_blocks"] = n + npad
    b2.pop("poolT", None)
    b2.pop("poolRGBA", None)
    return b2, geo2
