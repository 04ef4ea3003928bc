"""The SPVCNN shape-refiner heads as a coordinate-list sparse executor
(port of google_nerf_tpu/depth/spvcnn.py; the reference's torchsparse
`Minist_Test/lib/spvcnn_classsification.py:76-160`, fed by
`test_utils.pcd_to_sparsetensor:25-57` at voxel sizes 0.005/0.01 and
driven by `test_utils.refine_focal/refine_shift:112-131`).

  * active voxels stay a coordinate list (N, 3) with feature rows (N, C);
    the input comes padded to n_cap rows with a validity mask, as JAX
    takes it;
  * a coordinate packs into an int32 key of 3 x 10 bits, 2^31 - 1 for an
    invalid or out-of-range site; a level is its keys sorted ascending,
    and a neighbour lookup is torch.searchsorted on them (left side, as
    jnp.searchsorted);
  * JAX keeps every level at n_cap rows (its shapes are static), the
    invalid ones sorted to the tail, where every layer's output is zero.
    The port cuts each level to its valid rows, which are JAX's leading
    rows in JAX's order, so that it agrees with JAX row for row on them
    and does no work on the padding (one host read of the count a level);
  * sparse_conv sums, over the kernel offsets in torchsparse's
    KernelRegion order (x outermost, z fastest), a row gather of each
    output site's neighbour times that offset's (inc, outc) weight;
  * a stride-2 level is the sort-unique of its child level's coordinates
    halved;
  * the point branch devoxelizes x4 trilinearly at the input sites, and
    their rows are averaged onto x4's sites (index_add_; JAX sorts and
    differences a cumulative sum), then pooled over x4's active sites.

Everything runs in eval mode (BatchNorm on running statistics), as the
refiners use the heads (`test_shape.py:42-57`).  Parameters are a nested
dict of tensors with the keys of JAX's pytree; convert_spvcnn_state_dict
reads a torchsparse state dict by its torch names (kernel tensors (K,
inc, outc), K = k^3 offsets).  voxelize
runs on the host in numpy, as JAX's does: it keeps the first point of
each voxel in input order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from google_nerf_tpu_torch.utils.precision import exact_f32

# packed int32 keys give 3 x 10 bits; the voxelizer shifts coordinates to
# >= 0, so 1024^3 covers ~10 m at the reference's 0.01 voxel size (sites
# out of range are marked invalid)
CBITS = 10
CMAX = 1 << CBITS
INVALID = 2 ** 31 - 1

CS = (32, 32, 64, 128, 256)        # channel plan, spvcnn_classsification:83


def kernel_offsets(k: int) -> np.ndarray:
    """(k^3, 3) int offsets in torchsparse KernelRegion order (x outer,
    z fastest); odd k centred, even k forward."""
    lo = -(k - 1) // 2 if k % 2 else 0
    r = np.arange(lo, lo + k)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
    return g.reshape(-1, 3).astype(np.int32)


def _key(coords, valid):
    """(N, 3) int32 coordinates -> packed sortable int32 keys; INVALID
    where not valid or outside [0, CMAX)."""
    k = (coords[:, 0] << (2 * CBITS)) | (coords[:, 1] << CBITS) \
        | coords[:, 2]
    inb = ((coords >= 0) & (coords < CMAX)).all(1)
    return torch.where(valid & inb, k, torch.full_like(k, INVALID))


def _lookup(table_keys, qkeys):
    """Sorted-table membership query: returns (row_idx, found)."""
    idx = torch.searchsorted(table_keys, qkeys)
    idx = idx.clamp_max(table_keys.shape[0] - 1)
    found = (table_keys[idx] == qkeys) & (qkeys != INVALID)
    return idx, found


def _valid_rows(skey):
    """The number of valid keys of a sorted key list (they lead it)."""
    return int((skey != INVALID).sum())


class SparseLevel:
    """One resolution level: sorted unique voxel coordinates and their
    validity.  Coordinates are in the level's own units (parent = child
    >> 1); `skey` is the packed key, ascending; the rows are the valid
    ones of the input (JAX's leading rows; its tail of invalid rows is
    cut); `order` maps the level's rows to the input's."""

    def __init__(self, coords, valid):
        key = _key(coords, valid)
        order = torch.argsort(key, stable=True)
        order = order[:_valid_rows(key[order])]
        self.coords = coords[order]
        self.skey = key[order]
        self.valid = self.skey != INVALID
        self.order = order

    def query(self, qcoords, qvalid):
        return _lookup(self.skey, _key(qcoords, qvalid))


def _unique_level(coords, valid):
    """Sort-unique a coordinate list -> the SparseLevel of its distinct
    sites (duplicates invalidated, re-sorted to the tail and cut)."""
    key = _key(coords, valid)
    skey = key[torch.argsort(key, stable=True)]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    ukey = torch.where(first & (skey != INVALID), skey,
                       torch.full_like(skey, INVALID))
    ukey = ukey[torch.argsort(ukey, stable=True)]
    ukey = ukey[:_valid_rows(ukey)]
    lvl = SparseLevel.__new__(SparseLevel)
    lvl.coords = torch.stack([(ukey >> (2 * CBITS)) & (CMAX - 1),
                              (ukey >> CBITS) & (CMAX - 1),
                              ukey & (CMAX - 1)], 1).to(torch.int32)
    lvl.skey = ukey
    lvl.valid = ukey != INVALID
    lvl.order = None
    return lvl


def sparse_conv(lvl_in: SparseLevel, feats, w, lvl_out: SparseLevel,
                stride: int = 1):
    """out[j] = sum_k found * feats[idx(coord_out * stride + off_k)] @ w[k].

    w: (K, inc, outc); offsets from kernel_offsets(round(K ** (1/3))),
    summed in that order."""
    K = w.shape[0]
    k = round(K ** (1 / 3.0))
    offs = torch.as_tensor(kernel_offsets(k), device=feats.device)
    base = lvl_out.coords * stride
    out = feats.new_zeros((lvl_out.coords.shape[0], w.shape[2]))
    for ki in range(K):
        idx, found = lvl_in.query(base + offs[ki], lvl_out.valid)
        rows = feats[idx] * found[:, None]
        out = out + rows @ w[ki]
    return out * lvl_out.valid[:, None]


def _bn(x, p):
    inv = torch.rsqrt(p["var"] + 1e-5)
    return (x - p["mean"]) * (inv * p["gamma"]) + p["beta"]


def _bn_relu(x, p, valid):
    return _bn(x, p).clamp_min(0.0) * valid[:, None]


def _conv_bn_relu(lvl_in, feats, p, lvl_out, stride=1):
    h = sparse_conv(lvl_in, feats, p["conv"], lvl_out, stride)
    return _bn_relu(h, p["bn"], lvl_out.valid)


def _residual(lvl, feats, p):
    """spvcnn_classsification.ResidualBlock (stride 1)."""
    h = _conv_bn_relu(lvl, feats, p["c1"], lvl)
    h = _bn(sparse_conv(lvl, h, p["c2"]["conv"], lvl), p["c2"]["bn"])
    if "down" in p:
        idn = _bn(sparse_conv(lvl, feats, p["down"]["conv"], lvl),
                  p["down"]["bn"])
    else:
        idn = feats
    return (h + idn).clamp_min(0.0) * lvl.valid[:, None]


def _downsample_level(lvl: SparseLevel) -> SparseLevel:
    """Parent sites of a stride-2 conv: unique(floor(child / 2))."""
    return _unique_level(lvl.coords >> 1, lvl.valid)


def voxelize(points: np.ndarray, feats: np.ndarray, voxel_size: float,
             n_cap: int = 65536):
    """Host-side `pcd_to_sparsetensor` (test_utils.py:25-57): round to the
    voxel lattice, shift the minimum to 0, keep the FIRST point of each
    voxel; more than n_cap voxels are cut to n_cap by a seeded draw
    (default_rng(0)).  Returns (n_cap, 3) int32 coords, (n_cap, C) f32
    feats and (n_cap,) bool valid, in numpy."""
    pc = np.round(points / voxel_size)
    pc -= pc.min(0, keepdims=True)
    key = (pc[:, 0] * CMAX + pc[:, 1]) * CMAX + pc[:, 2]
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)
    if first.size > n_cap:
        first = np.random.default_rng(0).choice(first, n_cap, replace=False)
    coords = np.zeros((n_cap, 3), np.int32)
    f = np.zeros((n_cap, feats.shape[1]), np.float32)
    valid = np.zeros((n_cap,), bool)
    n = first.size
    coords[:n] = pc[first]
    f[:n] = feats[first]
    valid[:n] = True
    return coords, f, valid


def _tensors(coords, feats, valid, device):
    return (torch.as_tensor(coords, dtype=torch.int32, device=device),
            torch.as_tensor(feats, dtype=torch.float32, device=device),
            torch.as_tensor(valid, dtype=torch.bool, device=device))


def active_sites(coords, valid):
    """The active sites of the input level and of the four stride-2
    levels spvcnn_apply builds from it, as ints."""
    lvl = SparseLevel(torch.as_tensor(coords, dtype=torch.int32),
                      torch.as_tensor(valid, dtype=torch.bool))
    out = [int(lvl.valid.sum())]
    for _ in range(4):
        lvl = _downsample_level(lvl)
        out.append(int(lvl.valid.sum()))
    return out


def spvcnn_apply(params, coords, feats, valid):
    """Run the SPVCNN classifier on a voxelized cloud -> (num_classes,)
    logits.  coords (N, 3) int32, feats (N, C) f32 and valid (N,) bool,
    tensors (or numpy arrays, moved to the parameters' device).

    `SPVCNN_CLASSIFICATION.forward` (spvcnn_classsification.py:131-160)
    with pres == vres (the refiners' setting, test_shape.py:46-53):
    initial_voxelize is then the identity on the deduplicated input, and
    the stem-level voxel_to_point (integer coords, zero trilinear
    fraction) reduces to the site's own feature row.  The products run
    in float32 without TF32 (utils/precision.exact_f32)."""
    with torch.no_grad(), exact_f32():
        return _apply(params, coords, feats, valid)


def _apply(params, coords, feats, valid):
    dev = params["classifier"]["w"].device
    coords, feats, valid = _tensors(coords, feats, valid, dev)
    lvl0 = SparseLevel(coords, valid)
    f0 = feats[lvl0.order] * lvl0.valid[:, None]

    # stem: two 3^3 stride-1 conv+BN+ReLU
    h = _conv_bn_relu(lvl0, f0, params["stem"][0], lvl0)
    h = _conv_bn_relu(lvl0, h, params["stem"][1], lvl0)
    z0 = h                                     # voxel_to_point(x0, z)

    # four stages: 2^3 stride-2 conv + 2 residual blocks each
    lvl, feats_l = lvl0, h
    for st in params["stages"]:
        nxt = _downsample_level(lvl)
        feats_l = _conv_bn_relu(lvl, feats_l, st["down"], nxt, stride=2)
        feats_l = _residual(nxt, feats_l, st["res1"])
        feats_l = _residual(nxt, feats_l, st["res2"])
        lvl = nxt

    # point branch: z1 = trilinear devoxelize of x4 at the point coords
    # (stride 16), + point_transforms(z0) (spvcnn_utils.voxel_to_point:
    # 65-107; missing corners contribute zero, no renormalisation)
    x4, l4 = feats_l, lvl
    pos = lvl0.coords.float() / 16.0
    base = torch.floor(pos).to(torch.int32)
    frac = pos - base
    z1 = x4.new_zeros((lvl0.coords.shape[0], x4.shape[1]))
    for corner in range(8):
        off = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1,
                            corner & 1], dtype=torch.int32, device=dev)
        w = torch.where(off == 1, frac, 1.0 - frac).prod(1)
        idx, found = l4.query(base + off, lvl0.valid)
        z1 = z1 + (w * found)[:, None] * x4[idx]
    pt = params["point_transform"]
    zt = _bn_relu(z0 @ pt["w"].T + pt["b"], pt["bn"], lvl0.valid)
    z1 = (z1 + zt) * lvl0.valid[:, None]

    # point_to_voxel mean onto x4's active sites, then the global average
    # pool over them (spvcnn_utils.point_to_voxel:36-60,
    # spnn.GlobalAveragePooling); the invalid rows go to a spare slot
    pidx, pfound = l4.query(lvl0.coords >> 4, lvl0.valid)
    n4 = l4.coords.shape[0]
    slot = torch.where(pfound, pidx, torch.full_like(pidx, n4))
    sums = z1.new_zeros((n4 + 1, z1.shape[1])).index_add_(0, slot, z1)
    cnt = z1.new_zeros(n4 + 1).index_add_(0, slot, torch.ones_like(z1[:, 0]))
    sums, cnt = sums[:n4], cnt[:n4]
    has = (cnt > 0) & l4.valid
    y1 = torch.where(has[:, None], sums / cnt.clamp_min(1.0)[:, None], 0.0)

    pool = y1.sum(0) / l4.valid.sum().clamp_min(1)
    cl = params["classifier"]
    return pool @ cl["w"].T + cl["b"]


# ---------------------------------------------------------------------------
# parameters: init, and a torchsparse state dict read by its names
# ---------------------------------------------------------------------------

def _bn_p(c, device):
    return {"gamma": torch.ones(c, device=device),
            "beta": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def _conv_p(gen, k, inc, outc, device):
    w = torch.randn((k ** 3, inc, outc), generator=gen,
                    device=gen.device) / math.sqrt(k ** 3 * inc)
    return {"conv": w.to(device), "bn": _bn_p(outc, device)}


def init_spvcnn(generator: torch.Generator, input_channel: int,
                num_classes: int = 1, cr: float = 1.0, device="cuda"):
    """Parameters as JAX's init_spvcnn lays them out: conv kernels (K,
    inc, outc) normal / sqrt(fan_in), BatchNorm at identity, the point
    transform and classifier normal / sqrt(fan_in) with zero biases;
    drawn from `generator` (on its device), then moved to `device`."""
    cs = [int(cr * c) for c in CS]

    def conv(k, inc, outc):
        return _conv_p(generator, k, inc, outc, device)

    p = {"stem": [conv(3, input_channel, cs[0]), conv(3, cs[0], cs[0])],
         "stages": []}
    for inc, outc in zip(cs[:4], cs[1:]):
        st = {"down": conv(2, inc, inc),
              "res1": {"c1": conv(3, inc, outc), "c2": conv(3, outc, outc)},
              "res2": {"c1": conv(3, outc, outc),
                       "c2": conv(3, outc, outc)}}
        if inc != outc:
            st["res1"]["down"] = conv(1, inc, outc)
        p["stages"].append(st)

    def dense(dout, din):
        return (torch.randn((dout, din), generator=generator,
                            device=generator.device)
                / math.sqrt(din)).to(device)

    p["point_transform"] = {"w": dense(cs[4], cs[0]),
                            "b": torch.zeros(cs[4], device=device),
                            "bn": _bn_p(cs[4], device)}
    p["classifier"] = {"w": dense(num_classes, cs[4]),
                       "b": torch.zeros(num_classes, device=device)}
    return p


_BN_NAMES = (("gamma", "weight"), ("beta", "bias"),
             ("mean", "running_mean"), ("var", "running_var"))


def convert_spvcnn_state_dict(sd, cr: float = 1.0, offset_perm=None,
                              device="cuda"):
    """A torchsparse SPVCNN_CLASSIFICATION state dict (tensors or arrays
    by their torch names) -> the port's parameters.

    `offset_perm`: an optional (k^3,) permutation of the offset axis,
    for a checkpoint whose KernelRegion order differs from
    kernel_offsets (x outer, z fastest): kernel[offset_perm] is taken
    for every kernel of k^3 offsets.  JAX's converter indexes every
    kernel with it, so on an SPVCNN, which has 3^3, 2^3 and 1^3 kernels,
    it raises; the port permutes the kernels the permutation fits.  A
    1^3 kernel, stored (inc, outc) by torchsparse, gets its offset axis
    back.  A checkpoint whose first stem conv is named stem.0-2 is read
    so, as JAX's converter reads it."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def conv(prefix):
        w = np.asarray(sd[prefix + ".kernel"], np.float32)
        if w.ndim == 2:
            w = w[None]
        if offset_perm is not None and len(offset_perm) == w.shape[0]:
            w = w[np.asarray(offset_perm)]
        return t(w)

    def bn(prefix):
        return {ours: t(sd[f"{prefix}.{theirs}"])
                for ours, theirs in _BN_NAMES}

    def cbr(prefix_conv, prefix_bn):
        return {"conv": conv(prefix_conv), "bn": bn(prefix_bn)}

    cs = [int(cr * c) for c in CS]
    stem0 = (cbr("stem.0-2.0", "stem.0-2.1") if "stem.0-2.0.kernel" in sd
             else cbr("stem.0", "stem.1"))
    p = {"stem": [stem0, cbr("stem.3", "stem.4")], "stages": []}
    for si, (inc, outc) in enumerate(zip(cs[:4], cs[1:]), start=1):
        st = {"down": cbr(f"stage{si}.0.net.0", f"stage{si}.0.net.1")}
        for b in (1, 2):
            r = {"c1": cbr(f"stage{si}.{b}.net.0", f"stage{si}.{b}.net.1"),
                 "c2": cbr(f"stage{si}.{b}.net.3", f"stage{si}.{b}.net.4")}
            if b == 1 and inc != outc:
                r["down"] = cbr(f"stage{si}.1.downsample.0",
                                f"stage{si}.1.downsample.1")
            st[f"res{b}"] = r
        p["stages"].append(st)
    p["point_transform"] = {"w": t(sd["point_transforms.0.0.weight"]),
                            "b": t(sd["point_transforms.0.0.bias"]),
                            "bn": bn("point_transforms.0.1")}
    p["classifier"] = {"w": t(sd["classifier.0.weight"]),
                       "b": t(sd["classifier.0.bias"])}
    return p


# ---------------------------------------------------------------------------
# the refiners on the SPVCNN heads (test_utils.py:90-131)
# ---------------------------------------------------------------------------

def _image_coords(h, w, u0, v0):
    u = np.arange(w)[None, :].repeat(h, 0) - u0
    v = np.arange(h)[:, None].repeat(w, 1) - v0
    return u, v


def shift_cloud(depth_wshift: np.ndarray, focal: float, u0: float,
                v0: float):
    """The shift head's input (`test_utils.refine_shift:121-131`): the
    depth's point cloud, xyz as features, voxelized at 0.01."""
    h, w = depth_wshift.shape
    u, v = _image_coords(h, w, u0, v0)
    mask = depth_wshift > 1e-8
    x = depth_wshift * u / focal
    y = depth_wshift * v / focal
    pcd = np.stack([x, y, depth_wshift], -1)[mask]
    return voxelize(pcd, pcd, voxel_size=0.01)


def focal_cloud(depth: np.ndarray, focal: float, u0: float, v0: float):
    """The focal head's input (`test_utils.refine_focal:112-119`):
    features [xyz, (u - u0) / f, (v - v0) / f], voxelized at 0.005."""
    h, w = depth.shape
    u, v = _image_coords(h, w, u0, v0)
    mask = depth > 1e-8
    x = depth * u / focal
    y = depth * v / focal
    pcd = np.stack([x, y, depth], -1)[mask]
    uv = np.stack([u[mask] / focal, v[mask] / focal], -1)
    feats = np.concatenate([pcd, uv], 1)
    return voxelize(pcd, feats, voxel_size=0.005)


def refine_shift_spvcnn(depth_wshift: np.ndarray, params, focal: float,
                        u0: float, v0: float, max_shift: float = 0.7):
    """One shift-recovery step: depth -> point cloud -> voxelize(0.01) ->
    SPVCNN (3 channels) -> clamped at max_shift."""
    out = spvcnn_apply(params, *shift_cloud(depth_wshift, focal, u0, v0))
    return min(float(out[0]), max_shift)


def refine_focal_spvcnn(depth: np.ndarray, params, focal: float,
                        u0: float, v0: float):
    """One focal-recovery step: [xyz, uv / f] -> voxelize(0.005) ->
    SPVCNN (5 channels) -> the focal's scale."""
    out = spvcnn_apply(params, *focal_cloud(depth, focal, u0, v0))
    return float(out[0])


def params_to(params, device):
    """The parameters' tree with every tensor on `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)
