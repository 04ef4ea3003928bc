"""Brick-field kernels K1-K5: wrappers, plain PyTorch versions and the
numpy goldens.

Port of google_nerf_tpu/ops/pallas/brick_field.py:
  K1 `brick_field_tiles_wl`   worklist grid, init carry;
  K2 `brick_field_tiles_tp`   tile grid with list addressing, init carry;
  K3 `brick_field_tiles`      tile grid, row-layout pool, tiles from zero;
  K4 `brick_field_tiles_t`    as K3 on the transposed pool;
  K5 `brick_field_tiles_rgba` pre-shaded [log sigma, rgb] slabs, no MLP.
K1-K4 compute the function that `brick_field_tiles_reference` defines:
per 8x8 ray tile, its list of bricks is composited front to back, each
brick contributing the baked field (brick-local trilerp of 8 corners x
16 features, sigma from h0, rgb from the 32->64->64->3 MLP on [sh16,
h16]) with tau carried across bricks and the live gate tau < tau_max.
K5 computes `brick_field_rgba_reference`: the trilerped corner [log
sigma, r, g, b] with rgb clipped to [0, 1].

The CUDA kernels live in csrc/brick_field.cu and are built with nvcc on
first use into build/kernels/ (a plain C interface loaded with ctypes).
A wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback between the two.

Differences from the JAX entries:
  * K1-K3 read the baked row layout (n_blocks, Bk^3, 128), not the
    TPU's transposed (n_blocks, 128, Bk^3) copy; K4 takes the transposed
    copy, as its JAX entry does, and K5 the (n_blocks, 32, Bk^3) slabs;
  * `out` (optional) receives the result in place.  With a carry (K1,
    K2, K5) it starts as a copy of `init` (zeros if None); K3 and K4
    start each listed tile from zero.  Only listed tiles change, so every
    output row is defined, where JAX left the others undefined;
  * the JAX cost-estimate-only arguments inv2s/V are not taken.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import trilerp_w8
from google_nerf_tpu_torch.ops.cuda import _build
from google_nerf_tpu_torch.ops.ray_aabb import safe_inverse

TPX = 64          # rays per tile (8x8)
ROWW = 128        # pool row lanes (8 corners x 16 features)
FEAT = 16
RGBA_LANES = 32   # 8 corners x [log sigma, r, g, b]
ROWS, LANES, RGBA = 0, 1, 2     # pool layouts, as csrc/brick_field.cu
_smem_optin = {}


def build():
    """Compile csrc/brick_field.cu for sm_90a into build/kernels/ unless a
    library of the same source and flags is there.  Returns its path; the
    compiler's log (ptxas register and spill report) sits beside it."""
    return _build.build("brick_field")[0]


def _declare(lib):
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    head = [p, p, i64, p, p, p, i64, p, p, p, p, i32]
    tail = [i32, f32, f32, i32, p]               # S, dt, tau_max, Bk, stream
    lib.brick_field_wl.argtypes = head + [p, p, p, p, i32, i32] + tail
    for name in ("brick_field_tp", "brick_field_n", "brick_field_t"):
        getattr(lib, name).argtypes = head + [p, p, p, i32, i32] + tail
    lib.brick_field_rgba.argtypes = ([p, p, i64, p, p, i64, p, i32, p, p,
                                      p, i32, i32] + tail)
    for name in ("brick_field_wl", "brick_field_tp", "brick_field_n",
                 "brick_field_t", "brick_field_rgba",
                 "brick_field_smem_optin"):
        getattr(lib, name).restype = i32
    lib.brick_field_smem_optin.argtypes = []
    lib.brick_field_smem_bytes.argtypes = [i32, i32, i32]
    lib.brick_field_smem_bytes.restype = i64
    lib.brick_field_error_string.argtypes = [i32]
    lib.brick_field_error_string.restype = ctypes.c_char_p


def _lib():
    return _build.load("brick_field", _declare)


def window_span(max_samples: int, block: int, voxel_res: int,
                scale: float) -> int:
    """Longest lattice window inside one brick (the S of the kernels)."""
    s = min(0.5, scale)
    vox_w = 2.0 * s / voxel_res
    dt = math.sqrt(3.0) / max_samples
    return int(math.ceil(block * vox_w * math.sqrt(3.0) / dt)) + 1


# ---------------------------------------------------------------- goldens

def _golden_window(m, o, du, t1, t2, dt):
    inv_d = 1.0 / np.where(np.abs(du) > 1e-10, du,
                           np.where(du >= 0, 1e-10, -1e-10))
    t_lo = (m[0:3][None] - o) * inv_d
    t_hi = (m[3:6][None] - o) * inv_d
    ta = np.maximum(np.minimum(t_lo, t_hi).max(1), t1)
    tb = np.minimum(np.maximum(t_lo, t_hi).min(1), t2)
    n0 = np.maximum(np.ceil((ta - t1) / dt - 0.5), 0.0)
    n1 = np.floor((tb - t1) / dt - 0.5)
    return n0, n1, (tb > ta) & (n1 >= n0) & (t2 > 0)


def _golden_voxel(m, o, du, ts, Bk):
    xyz = o + ts[:, None] * du
    u = np.clip((xyz - m[0:3][None]) * Bk / (m[3:6] - m[0:3])[None], 0.0,
                Bk - 1e-3)
    v0 = np.floor(u)
    frac = u - v0
    lid = ((v0[:, 0] * Bk + v0[:, 1]) * Bk + v0[:, 2]).astype(np.int64)
    w8 = np.ones((TPX, 8))
    for k in range(3):
        bit = (np.arange(8)[None] >> k) & 1
        w8 = w8 * np.where(bit == 1, frac[:, k:k + 1], 1.0 - frac[:, k:k + 1])
    return lid, w8


def _golden(pool_blk, meta, rays, tid, lbase, nslots, S, dt, tau_max, Bk,
            field):
    """The goldens' shared walk: field(pool block, tile's ray slice, lid,
    w8) -> (h0, rgb) of one window sample of the tile's 64 rays."""
    pool_blk = np.asarray(pool_blk)
    meta = np.asarray(meta, np.float32)
    rays = np.asarray(rays, np.float32)
    T = rays.shape[0] // TPX
    Lp = pool_blk.shape[0] // T
    if tid is None:
        tid = np.arange(T, dtype=np.int32)
    if lbase is None:
        lbase = tid.astype(np.int32) * Lp
    if nslots is None:
        nslots = np.full(tid.shape, Lp, np.int32)
    out = np.zeros((T * TPX, 8), np.float32)
    for b in range(len(tid)):
        t = int(tid[b])
        sl = slice(t * TPX, (t + 1) * TPX)
        o, du = rays[sl, 0:3], rays[sl, 3:6]
        t1, t2 = rays[sl, 6], rays[sl, 7]
        out[sl] = 0.0
        for l in range(int(nslots[b])):
            row = int(lbase[b]) + l
            m = meta[row]
            n0, n1, hit = _golden_window(m, o, du, t1, t2, dt)
            tau_tot = out[sl, 0]
            live = tau_tot < tau_max
            if not np.any(hit & live):
                continue
            tau_c = np.zeros(TPX)
            rgbw = np.zeros((TPX, 3))
            depw = np.zeros(TPX)
            for s in range(S):
                n_s = n0 + s
                s_ok = hit & (n_s <= n1)
                ts = t1 + (n_s + 0.5) * dt
                h0, rgb_s = field(int(pool_blk[row]), sl,
                                  *_golden_voxel(m, o, du, ts, Bk))
                sd = np.where(s_ok, np.exp(np.minimum(h0, 30.0)) * dt, 0.0)
                sd = np.minimum(sd, 80.0)
                w = np.exp(-tau_c) * (1.0 - np.exp(-sd))
                rgbw += w[:, None] * rgb_s
                depw += w * ts
                tau_c += sd
            T_bef = np.where(live, np.exp(-tau_tot), 0.0)
            out[sl, 0] += np.where(live, tau_c, 0.0)
            out[sl, 1:4] += T_bef[:, None] * rgbw
            out[sl, 4] += T_bef * depw
            out[sl, 5] += (hit & live).astype(np.float32)
    return out


def brick_field_tiles_reference(pool_blk, meta, rays, sh, pool3, w1,
                                w2, w3, *, S, dt, inv2s, V, tau_max,
                                tid=None, lbase=None, nslots=None,
                                Bk: int = 8):
    """Pure-numpy restatement of K1-K4 (the JAX package's golden): same
    slot order, early-termination rule and tid/lbase/nslots list
    addressing; f32/f64 arithmetic throughout.  pool3 (n_blocks, Bk^3,
    128)."""
    sh = np.asarray(sh, np.float32)
    pool3 = np.asarray(pool3, np.float32)
    w1, w2, w3 = (np.asarray(w, np.float32) for w in (w1, w2, w3))

    def field(blk, sl, lid, w8):
        rows = pool3[blk][lid].reshape(TPX, 8, FEAT)
        h = np.einsum("nc,ncf->nf", w8, rows)
        a = np.maximum(np.concatenate([sh[sl], h], 1) @ w1, 0.0)
        a = np.maximum(a @ w2, 0.0)
        return h[:, 0], 1.0 / (1.0 + np.exp(-(a @ w3)))

    return _golden(pool_blk, meta, rays, tid, lbase, nslots, S, dt, tau_max,
                   Bk, field)


def brick_field_rgba_reference(pool_blk, meta, rays, poolRGBA, *, S, dt,
                               inv2s, V, tau_max, tid=None, lbase=None,
                               nslots=None, Bk: int = 8):
    """Numpy restatement of K5 (the JAX package's golden) with the list
    addressing, termination and ordering of brick_field_tiles_reference;
    poolRGBA (n_blocks, 32, Bk^3)."""
    poolRGBA = np.asarray(poolRGBA, np.float32)

    def field(blk, sl, lid, w8):
        rows = poolRGBA[blk][:, lid].T.reshape(TPX, 8, 4)
        h4 = np.einsum("nc,ncf->nf", w8, rows)
        return h4[:, 0], np.clip(h4[:, 1:4], 0.0, 1.0)

    return _golden(pool_blk, meta, rays, tid, lbase, nslots, S, dt, tau_max,
                   Bk, field)


# ---------------------------------------------------------- plain versions

def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the TPU kernel's operand casts."""
    return x.to(torch.bfloat16).float()


def _lerp_w8(frac):
    """Corner weights in the TPU t-kernels' form: per axis (1 - f) +
    bit * (2f - 1), which can differ from trilerp_w8 in the last bit."""
    bits = torch.tensor([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                        dtype=frac.dtype, device=frac.device)
    f = frac[..., None, :]                                    # (..., 1, 3)
    w = (1.0 - f) + bits * (2.0 * f - 1.0)                    # (..., 8, 3)
    return w[..., 0] * w[..., 1] * w[..., 2]


def slab_window(rays, meta_rows, dt: float):
    """Slab test of B tiles' rays against one brick each, and the lattice
    window it leaves: rays (B, 64, 8), meta_rows (B, 8) -> first and last
    window sample n0, n1 (B, 64) f32 and hit (B, 64) bool."""
    # divide by a device tensor: a Python-scalar divisor becomes a
    # multiply by its reciprocal on CUDA, which can move ceil/floor
    dt_t = torch.tensor(dt, dtype=torch.float32, device=rays.device)
    o, du, t1, t2 = rays[..., 0:3], rays[..., 3:6], rays[..., 6], rays[..., 7]
    lo, hi = meta_rows[:, None, 0:3], meta_rows[:, None, 3:6]
    inv_d = safe_inverse(du)
    p, q = (lo - o) * inv_d, (hi - o) * inv_d
    ta = torch.maximum(torch.minimum(p, q).amax(-1), t1)
    tb = torch.minimum(torch.maximum(p, q).amin(-1), t2)
    n0 = torch.clamp_min(torch.ceil((ta - t1) / dt_t - 0.5), 0.0)
    n1 = torch.floor((tb - t1) / dt_t - 0.5)
    return n0, n1, (tb > ta) & (n1 >= n0) & (t2 > 0)


def _mlp_field(pool3, shv, ws, *, lanes: bool, lerp: bool):
    """K1-K4's field of M samples: (bi tile, ri ray, blk pool block, lid
    voxel row, frac (M, 3)) -> (h0, rgb), in the kernels' roundings (bf16
    slab, bf16-rounded corner products and MLP operands, f32 sums).
    lanes: pool3 is (n_blocks, 128, Bk^3); lerp: the t-kernels' weights."""
    w1b, w2b, w3b = (_bf(w) for w in ws)
    weights = _lerp_w8 if lerp else trilerp_w8

    def field(bi, ri, blk, lid, frac):
        rows = pool3[blk, :, lid] if lanes else pool3[blk, lid]
        rows = _bf(rows).reshape(-1, 8, FEAT)
        h = _bf(weights(frac)[..., None] * rows).sum(-2)         # (M, 16)
        a1 = torch.relu(_bf(shv[bi, ri]) @ w1b[:FEAT] + _bf(h) @ w1b[FEAT:])
        a2 = torch.relu(_bf(a1) @ w2b)
        return h[:, 0], torch.sigmoid(_bf(a2) @ w3b)

    return field


def _rgba_field(poolRGBA):
    """K5's field: trilerp of the pre-shaded corner lanes (corner = lane
    // 4, channel = lane % 4), rgb clipped to [0, 1]."""
    def field(bi, ri, blk, lid, frac):
        rows = _bf(poolRGBA[blk, :, lid]).reshape(-1, 8, 4)
        h4 = _bf(_lerp_w8(frac)[..., None] * rows).sum(-2)       # (M, 4)
        return h4[:, 0], torch.clamp(h4[:, 1:4], 0.0, 1.0)

    return field


def _slot_step(st, rays, meta_rows, pb, valid, field, *, S, dt, tau_max,
               Bk):
    """Composite one list slot into the carried state of B tiles.

    st (B, 64, 8) f32 state, updated in place; rays (B, 64, 8);
    meta_rows (B, 8); pb (B,) pool block; valid (B,) bool; field as
    _mlp_field.  Vectorized over tiles, rays and window samples; the
    composite runs in the kernels' order with f32 accumulation."""
    dev = st.device
    dt_t = torch.tensor(dt, dtype=torch.float32, device=dev)
    o, du, t1 = rays[..., 0:3], rays[..., 3:6], rays[..., 6]
    n0, n1, hit = slab_window(rays, meta_rows, dt)
    act = valid[:, None] & hit & (st[..., 0] < tau_max)   # live hit rays
    if not bool(act.any()):
        return
    n_s = n0[..., None] + torch.arange(S, dtype=torch.float32, device=dev)
    ts = t1[..., None] + (n_s + 0.5) * dt_t      # (B, 64, S)
    ok = act[..., None] & (n_s <= n1[..., None])
    bi, ri, si = ok.nonzero(as_tuple=True)

    # field of the live samples only (the rest contribute exactly zero)
    xyz = o[bi, ri] + ts[bi, ri, si][:, None] * du[bi, ri]
    lo_s, hi_s = meta_rows[bi, 0:3], meta_rows[bi, 3:6]
    u = (xyz - lo_s) * (torch.full_like(lo_s, float(Bk)) / (hi_s - lo_s))
    u = torch.clamp(u, 0.0, Bk - 1e-3)
    v0 = torch.floor(u)
    lid = ((v0[:, 0] * Bk + v0[:, 1]) * Bk + v0[:, 2]).long()
    h0, rgb = field(bi, ri, pb[bi], lid, u - v0)
    sd = torch.clamp_max(torch.exp(torch.clamp_max(h0, 30.0)) * dt_t, 80.0)

    sd_d = torch.zeros(ok.shape, device=dev)
    rgb_d = torch.zeros(ok.shape + (3,), device=dev)
    sd_d[bi, ri, si] = sd
    rgb_d[bi, ri, si] = rgb
    run = torch.zeros(act.shape, device=dev)
    rgbw = torch.zeros(act.shape + (3,), device=dev)
    depw = torch.zeros(act.shape, device=dev)
    for s in range(S):
        w = torch.exp(-run) * (1.0 - torch.exp(-sd_d[..., s]))
        rgbw = rgbw + w[..., None] * rgb_d[..., s, :]
        depw = depw + w * ts[..., s]
        run = run + sd_d[..., s]
    T_bef = torch.where(act, torch.exp(-st[..., 0]), 0.0)
    st[..., 0] += torch.where(act, run, 0.0)
    st[..., 1:4] += T_bef[..., None] * rgbw
    st[..., 4] += T_bef * depw
    st[..., 5] += act.float()


def _tiles_plain(pool_blk, meta, rays, tid, lbase, nslots, out, make_field,
                 *, S, dt, tau_max, Lcall, Bk, zero):
    """Tiles tid[b] walk list rows lbase[b] + l, l < min(nslots[b],
    Lcall), from the state already in `out` (which holds init), or from
    zero if `zero`.  make_field(tile ids) -> the field of those tiles."""
    T = rays.shape[0] // TPX
    n_rows = meta.shape[0]
    tid_l = tid.long()
    st = out.view(T, TPX, 8)[tid_l].clone()
    if zero:
        st.zero_()
    r = rays.view(T, TPX, 8)[tid_l]
    field = make_field(tid_l)
    for l in range(Lcall):
        valid = l < nslots
        if not bool(valid.any()):
            break
        rows = (lbase.long() + l).clamp(0, n_rows - 1)
        _slot_step(st, r, meta[rows], pool_blk[rows].long(), valid, field,
                   S=S, dt=dt, tau_max=tau_max, Bk=Bk)
    out.view(T, TPX, 8)[tid_l] = st
    return out


def _mlp_maker(sh, pool3, ws, *, lanes=False, lerp=False):
    T = sh.shape[0] // TPX
    return lambda tid_l: _mlp_field(pool3, sh.view(T, TPX, FEAT)[tid_l], ws,
                                    lanes=lanes, lerp=lerp)


def _wl_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, wt, wl, wn, wf,
              out, *, S, dt, tau_max, P, Bk):
    """Each worklist step with wf==1 starts a tile, which takes the
    following steps while wt is unchanged (and wf==0); a step renders
    list rows wl[j] .. wl[j] + wn[j] - 1."""
    T = rays.shape[0] // TPX
    n_rows = meta.shape[0]
    wt_h, wn_h, wf_h = (x.cpu().numpy() for x in (wt, wn, wf))
    tiles, runs = [], []
    for j0 in np.flatnonzero(wf_h == 1):
        if not 0 <= wt_h[j0] < T:
            continue
        j, steps = j0, []
        while j < len(wt_h) and (j == j0 or (wt_h[j] == wt_h[j0]
                                             and wf_h[j] != 1)):
            if wn_h[j] > 0:
                steps.append(j)
            j += 1
        tiles.append(int(wt_h[j0]))
        runs.append(steps)
    if not tiles:
        return out
    dev = out.device
    tid_l = torch.as_tensor(tiles, device=dev)
    st = out.view(T, TPX, 8)[tid_l].clone()
    r = rays.view(T, TPX, 8)[tid_l]
    field = _mlp_maker(sh, pool3, (w1, w2, w3))(tid_l)
    for c in range(max(len(s) for s in runs)):
        step = torch.as_tensor([s[c] if c < len(s) else -1 for s in runs],
                               device=dev)
        j = step.clamp_min(0)
        n = torch.where(step >= 0, torch.clamp(wn[j].long(), max=P), 0)
        for k in range(P):
            valid = k < n
            if not bool(valid.any()):
                break
            rows = (wl[j].long() + k).clamp(0, n_rows - 1)
            _slot_step(st, r, meta[rows], pool_blk[rows].long(), valid,
                       field, S=S, dt=dt, tau_max=tau_max, Bk=Bk)
    out.view(T, TPX, 8)[tid_l] = st
    return out


# ------------------------------------------------------ argument handling

def _check(name, t, device, dtype=None, shape=None):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the pool on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _index(name, t, device, n):
    """Index array as contiguous int32 (JAX's astype), length-checked."""
    t = torch.as_tensor(t, device=device).to(torch.int32).contiguous()
    if t.shape != (n,):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected ({n},)")
    return t


def _check_smem(kind, S, Bk, dev):
    """Raise unless the kernel's shared memory at (S, Bk) fits the
    device's opt-in limit for one block."""
    lib = _lib()
    if dev.index not in _smem_optin:
        with torch.cuda.device(dev):
            _smem_optin[dev.index] = lib.brick_field_smem_optin()
    need, have = lib.brick_field_smem_bytes(kind, S, Bk), _smem_optin[
        dev.index]
    if need > have:
        raise ValueError(f"S={S}, Bk={Bk} needs {need} bytes of shared "
                         f"memory a block; {dev} allows {have}")


def _prepare(pool_blk, meta, rays, sh, pool3, ws, S, Bk, init, out, *,
             kind, carry):
    """Checks shared by the kernels; returns (T, pool_blk int32, out).
    sh and ws are None for K5; carry: the kernel takes `init`."""
    dev = pool3.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no brick-field kernel for device {dev}")
    vox = Bk ** 3
    lanes = {ROWS: (vox, ROWW), LANES: (ROWW, vox),
             RGBA: (RGBA_LANES, vox)}[kind]
    if pool3.ndim != 3 or tuple(pool3.shape[1:]) != lanes:
        raise ValueError(f"pool: shape {tuple(pool3.shape)}, expected "
                         f"(n_blocks, {lanes[0]}, {lanes[1]})")
    _check("pool", pool3, dev, torch.bfloat16 if dev.type == "cuda" else None)
    if dev.type == "cuda" and pool3.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned")
    if S < 1:
        raise ValueError(f"window span S={S} < 1")
    if dev.type == "cuda":
        _check_smem(kind, S, Bk, dev)
    if rays.ndim != 2 or rays.shape[0] % TPX or rays.shape[1] != 8:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected "
                         f"(T*{TPX}, 8)")
    T = rays.shape[0] // TPX
    n_rows = meta.shape[0]
    checks = [("rays", rays, None), ("meta", meta, (n_rows, 8))]
    if sh is not None:
        checks += [("sh", sh, (T * TPX, FEAT)), ("w1", ws[0], (32, 64)),
                   ("w2", ws[1], (64, 64)), ("w3", ws[2], (64, 3))]
    for name, t, shape in checks:
        _check(name, t, dev, torch.float32, shape)
    pool_blk = _index("pool_blk", pool_blk, dev, n_rows)
    if not carry:
        if out is None:
            return T, pool_blk, torch.zeros((T * TPX, 8), device=dev)
        _check("out", out, dev, torch.float32, (T * TPX, 8))
        return T, pool_blk, out
    if init is None:
        init = torch.zeros((T * TPX, 8), dtype=torch.float32, device=dev)
    _check("init", init, dev, torch.float32, (T * TPX, 8))
    if out is None:
        out = init.clone()
    else:
        _check("out", out, dev, torch.float32, (T * TPX, 8))
        if out.data_ptr() != init.data_ptr():
            out.copy_(init)
    return T, pool_blk, out


def _prepare_wl(pool_blk, meta, rays, sh, pool3, w1, w2, w3, wt, wl, wn, wf,
                S, Bk, init, out):
    T, pool_blk, out = _prepare(pool_blk, meta, rays, sh, pool3,
                                (w1, w2, w3), S, Bk, init, out, kind=ROWS,
                                carry=True)
    Ns = wt.shape[0]
    wt, wl, wn, wf = (_index(n, x, pool3.device, Ns) for n, x in
                      (("wt", wt), ("wl", wl), ("wn", wn), ("wf", wf)))
    return T, pool_blk, wt, wl, wn, wf, out


def _prepare_tiles(pool_blk, meta, rays, sh, pool3, ws, tid, lbase, nslots,
                   Lcall, S, Bk, init, out, *, kind, carry):
    """Checks of the tile-list kernels (K2-K5) -> (T, pool_blk, tid,
    lbase, nslots, Lcall, out).  Defaults: every tile, lbase = tid * Lp,
    nslots = Lcall = Lp with Lp = n_rows // T."""
    T, pool_blk, out = _prepare(pool_blk, meta, rays, sh, pool3, ws, S, Bk,
                                init, out, kind=kind, carry=carry)
    dev = pool3.device
    Lp = meta.shape[0] // T
    tid = (torch.arange(T, device=dev) if tid is None
           else torch.as_tensor(tid, device=dev))
    Tb = tid.shape[0]
    tid = _index("tid", tid, dev, Tb)
    lbase = _index("lbase", tid * Lp if lbase is None else lbase, dev, Tb)
    nslots = _index("nslots", torch.full((Tb,), Lp) if nslots is None
                    else nslots, dev, Tb)
    # a check on device values: on CUDA a device-side assert, so the host
    # does not wait for the queue (it fails at the next sync instead)
    st = torch.sort(tid).values
    _assert_values((st[1:] != st[:-1]).all(), "tid entries must be distinct")
    return T, pool_blk, tid, lbase, nslots, Lcall or Lp, out


def _prepare_tp(pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid, lbase,
                nslots, Lcall, P, S, Bk, init, out):
    T, pool_blk, tid, lbase, nslots, Lcall, out = _prepare_tiles(
        pool_blk, meta, rays, sh, pool3, (w1, w2, w3), tid, lbase, nslots,
        Lcall, S, Bk, init, out, kind=ROWS, carry=True)
    if Lcall % P:
        raise ValueError(f"Lcall={Lcall} is not a multiple of P={P}")
    _assert_values((lbase % P == 0).all(),
                   f"every lbase must be a multiple of P={P}")
    return T, pool_blk, tid, lbase, nslots, Lcall, out


def _assert_values(ok: torch.Tensor, msg: str):
    if ok.is_cuda:
        torch._assert_async(ok, msg)
    elif not bool(ok):
        raise ValueError(msg)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _launch(name, *cargs, dev):
    """Call the C entry `name` on dev's current stream; raise on error."""
    with torch.cuda.device(dev):
        lib = _lib()
        err = getattr(lib, name)(
            *cargs, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        msg = lib.brick_field_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _launch_tiles(name, pool_blk, meta, rays, sh, pool3, ws, out, T, tid,
                  lbase, nslots, Lcall, S, dt, tau_max, Bk):
    if tid.shape[0] == 0:
        return False
    head = [_ptr(pool_blk), _ptr(meta), meta.shape[0], _ptr(rays)]
    if name == "brick_field_rgba":
        body = [_ptr(pool3), pool3.shape[0], _ptr(out), T]
    else:
        body = [_ptr(sh), _ptr(pool3), pool3.shape[0], *map(_ptr, ws),
                _ptr(out), T]
    _launch(name, *head, *body, _ptr(tid), _ptr(lbase), _ptr(nslots),
            tid.shape[0], Lcall, S, dt, tau_max, Bk, dev=pool3.device)
    return True


# ---------------------------------------------------------------- entries

def brick_field_tiles_wl(pool_blk, meta, rays, sh, pool3, w1, w2, w3,
                         wt, wl, wn, wf, *, S: int, dt: float,
                         tau_max: float, P: int = 16, Bk: int = 8,
                         init=None, out=None):
    """K1, worklist grid.  Step j renders list rows wl[j] .. wl[j] +
    wn[j] - 1 (wn <= P; 0 = pad step) of tile wt[j]; wf[j] == 1 marks a
    tile's first step, which loads its `init` carry.  A tile's steps are
    consecutive and start with its wf == 1 step; pad steps repeat the
    last real wt.

    pool_blk (n_rows,) int pool block and meta (n_rows, 8) f32 [lo, hi,
    pad, pad] per list row; rays (T*64, 8) f32 [o, unit d, t1, t2]; sh
    (T*64, 16) f32; pool3 (n_blocks, Bk^3, 128), bf16 on CUDA; w1/w2/w3
    (32,64)/(64,64)/(64,3) f32.  Returns (T*64, 8) f32 [tau, rgb, depth*w,
    n_pairs, init cols 6-7]; tiles absent from the worklist keep init.
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    T, pool_blk, wt, wl, wn, wf, out = _prepare_wl(
        pool_blk, meta, rays, sh, pool3, w1, w2, w3, wt, wl, wn, wf, S, Bk,
        init, out)
    if pool3.device.type == "cpu":
        return _wl_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, wt,
                         wl, wn, wf, out, S=S, dt=dt, tau_max=tau_max, P=P,
                         Bk=Bk)
    if wt.shape[0] == 0:
        return out
    _launch("brick_field_wl", _ptr(pool_blk), _ptr(meta), meta.shape[0],
            _ptr(rays), _ptr(sh), _ptr(pool3), pool3.shape[0], _ptr(w1),
            _ptr(w2), _ptr(w3), _ptr(out), T, _ptr(wt), _ptr(wl), _ptr(wn),
            _ptr(wf), wt.shape[0], P, S, dt, tau_max, Bk, dev=pool3.device)
    brick_field_tiles_wl.launches += 1
    return out


brick_field_tiles_wl.launches = 0


def brick_field_tiles_wl_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3,
                               wt, wl, wn, wf, *, S: int, dt: float,
                               tau_max: float, P: int = 16, Bk: int = 8,
                               init=None, out=None):
    """Plain PyTorch version of K1 on any device (same contract)."""
    _, pool_blk, wt, wl, wn, wf, out = _prepare_wl(
        pool_blk, meta, rays, sh, pool3, w1, w2, w3, wt, wl, wn, wf, S, Bk,
        init, out)
    return _wl_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, wt, wl,
                     wn, wf, out, S=S, dt=dt, tau_max=tau_max, P=P, Bk=Bk)


def brick_field_tiles_tp(pool_blk, meta, rays, sh, pool3, w1, w2, w3, *,
                         S: int, dt: float, tau_max: float, tid=None,
                         lbase=None, nslots=None, Lcall: int = 0, P: int = 4,
                         Bk: int = 8, init=None, out=None):
    """K2, tile grid with list addressing.  Tile tid[b] (distinct) walks
    list rows lbase[b] + l for l < min(nslots[b], Lcall) from its `init`
    carry.  Defaults: every tile, lbase = tid * Lp, nslots = Lcall = Lp
    with Lp = n_rows // T.  The JAX entry's contract, checked loudly:
    Lcall % P == 0 and every lbase a multiple of P; tid distinct (CUDA
    blocks of one tile would race).  On CUDA tensors the checks of lbase
    and tid are device-side asserts, which add no host sync.  Other
    arguments and the return value as in brick_field_tiles_wl."""
    T, pool_blk, tid, lbase, nslots, Lcall, out = _prepare_tp(
        pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid, lbase, nslots,
        Lcall, P, S, Bk, init, out)
    if pool3.device.type == "cpu":
        return _tiles_plain(pool_blk, meta, rays, tid, lbase, nslots, out,
                            _mlp_maker(sh, pool3, (w1, w2, w3)), S=S, dt=dt,
                            tau_max=tau_max, Lcall=Lcall, Bk=Bk, zero=False)
    if _launch_tiles("brick_field_tp", pool_blk, meta, rays, sh, pool3,
                     (w1, w2, w3), out, T, tid, lbase, nslots, Lcall, S, dt,
                     tau_max, Bk):
        brick_field_tiles_tp.launches += 1
    return out


brick_field_tiles_tp.launches = 0


def brick_field_tiles_tp_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3,
                               *, S: int, dt: float, tau_max: float,
                               tid=None, lbase=None, nslots=None,
                               Lcall: int = 0, P: int = 4, Bk: int = 8,
                               init=None, out=None):
    """Plain PyTorch version of K2 on any device (same contract)."""
    _, pool_blk, tid, lbase, nslots, Lcall, out = _prepare_tp(
        pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid, lbase, nslots,
        Lcall, P, S, Bk, init, out)
    return _tiles_plain(pool_blk, meta, rays, tid, lbase, nslots, out,
                        _mlp_maker(sh, pool3, (w1, w2, w3)), S=S, dt=dt,
                        tau_max=tau_max, Lcall=Lcall, Bk=Bk, zero=False)


def _dense(name, kind, pool_blk, meta, rays, sh, pool3, w1, w2, w3, S, dt,
           tau_max, tid, lbase, nslots, Lcall, Bk, out, plain):
    """K3 (row pool) and K4 (transposed pool): each listed tile from
    zero, one slot at a time; `plain` forces the plain version."""
    T, pool_blk, tid, lbase, nslots, Lcall, out = _prepare_tiles(
        pool_blk, meta, rays, sh, pool3, (w1, w2, w3), tid, lbase, nslots,
        Lcall, S, Bk, None, out, kind=kind, carry=False)
    lanes = kind == LANES
    if plain or pool3.device.type == "cpu":
        return _tiles_plain(pool_blk, meta, rays, tid, lbase, nslots, out,
                            _mlp_maker(sh, pool3, (w1, w2, w3), lanes=lanes,
                                       lerp=lanes),
                            S=S, dt=dt, tau_max=tau_max, Lcall=Lcall, Bk=Bk,
                            zero=True), False
    return out, _launch_tiles(name, pool_blk, meta, rays, sh, pool3,
                              (w1, w2, w3), out, T, tid, lbase, nslots,
                              Lcall, S, dt, tau_max, Bk)


def brick_field_tiles(pool_blk, meta, rays, sh, pool3, w1, w2, w3, *,
                      S: int, dt: float, tau_max: float, tid=None,
                      lbase=None, nslots=None, Lcall: int = 0, Bk: int = 8,
                      out=None):
    """K3, dense tile grid, one list slot at a time.  Tile tid[b]
    (distinct) walks list rows lbase[b] + l for l < min(nslots[b], Lcall)
    from zero, as the JAX kernel zeroes its block at l == 0.  pool3 is the
    row layout (n_blocks, Bk^3, 128), bf16 on CUDA; defaults, other
    arguments and the return value as in brick_field_tiles_tp, without P
    and init.  `out` (optional) is written in place: listed tiles are
    rendered from zero and every other row is kept."""
    out, launched = _dense("brick_field_n", ROWS, pool_blk, meta,
                           rays, sh, pool3, w1, w2, w3, S, dt, tau_max, tid,
                           lbase, nslots, Lcall, Bk, out, False)
    brick_field_tiles.launches += launched
    return out


brick_field_tiles.launches = 0


def brick_field_tiles_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, *,
                            S: int, dt: float, tau_max: float, tid=None,
                            lbase=None, nslots=None, Lcall: int = 0,
                            Bk: int = 8, out=None):
    """Plain PyTorch version of K3 on any device (same contract)."""
    return _dense("brick_field_n", ROWS, pool_blk, meta, rays, sh,
                  pool3, w1, w2, w3, S, dt, tau_max, tid, lbase, nslots,
                  Lcall, Bk, out, True)[0]


def brick_field_tiles_t(pool_blk, meta, rays, sh, pool3T, w1, w2, w3, *,
                        S: int, dt: float, tau_max: float, tid=None,
                        lbase=None, nslots=None, Lcall: int = 0, Bk: int = 8,
                        out=None):
    """K4: K3's contract on the transposed pool pool3T (n_blocks, 128,
    Bk^3), as the JAX entry takes it (render_brick_mxu caches the copy as
    baked["poolT"]).  Corner weights take the TPU t-kernel's form."""
    out, launched = _dense("brick_field_t", LANES, pool_blk, meta,
                           rays, sh, pool3T, w1, w2, w3, S, dt, tau_max, tid,
                           lbase, nslots, Lcall, Bk, out, False)
    brick_field_tiles_t.launches += launched
    return out


brick_field_tiles_t.launches = 0


def brick_field_tiles_t_plain(pool_blk, meta, rays, sh, pool3T, w1, w2, w3,
                              *, S: int, dt: float, tau_max: float, tid=None,
                              lbase=None, nslots=None, Lcall: int = 0,
                              Bk: int = 8, out=None):
    """Plain PyTorch version of K4 on any device (same contract)."""
    return _dense("brick_field_t", LANES, pool_blk, meta, rays, sh,
                  pool3T, w1, w2, w3, S, dt, tau_max, tid, lbase, nslots,
                  Lcall, Bk, out, True)[0]


def _rgba(pool_blk, meta, rays, poolRGBA, S, dt, tau_max, tid, lbase,
          nslots, Lcall, Bk, init, out, plain):
    T, pool_blk, tid, lbase, nslots, Lcall, out = _prepare_tiles(
        pool_blk, meta, rays, None, poolRGBA, None, tid, lbase, nslots,
        Lcall, S, Bk, init, out, kind=RGBA, carry=True)
    if plain or poolRGBA.device.type == "cpu":
        return _tiles_plain(pool_blk, meta, rays, tid, lbase, nslots, out,
                            lambda _: _rgba_field(poolRGBA), S=S, dt=dt,
                            tau_max=tau_max, Lcall=Lcall, Bk=Bk,
                            zero=False), False
    return out, _launch_tiles("brick_field_rgba", pool_blk, meta, rays,
                              None, poolRGBA, None, out, T, tid, lbase,
                              nslots, Lcall, S, dt, tau_max, Bk)


def brick_field_tiles_rgba(pool_blk, meta, rays, poolRGBA, *, S: int,
                           dt: float, tau_max: float, tid=None, lbase=None,
                           nslots=None, Lcall: int = 0, Bk: int = 8,
                           init=None, out=None):
    """K5, pre-shaded slabs: K2's list addressing and `init` carry (no
    P), no sh and no MLP.  poolRGBA (n_blocks, 32, Bk^3), bf16 on CUDA:
    lane = corner * 4 + channel, channels [log sigma, r, g, b], corner
    bits as trilerp_w8.  rgb is the clipped trilerp of the corners'."""
    out, launched = _rgba(pool_blk, meta, rays, poolRGBA, S, dt, tau_max,
                          tid, lbase, nslots, Lcall, Bk, init, out, False)
    brick_field_tiles_rgba.launches += launched
    return out


brick_field_tiles_rgba.launches = 0


def brick_field_tiles_rgba_plain(pool_blk, meta, rays, poolRGBA, *, S: int,
                                 dt: float, tau_max: float, tid=None,
                                 lbase=None, nslots=None, Lcall: int = 0,
                                 Bk: int = 8, init=None, out=None):
    """Plain PyTorch version of K5 on any device (same contract)."""
    return _rgba(pool_blk, meta, rays, poolRGBA, S, dt, tau_max, tid, lbase,
                 nslots, Lcall, Bk, init, out, True)[0]
