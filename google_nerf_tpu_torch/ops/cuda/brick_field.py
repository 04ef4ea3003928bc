"""Brick-field kernels K1 (worklist grid) and K2 (tile grid with list
addressing): wrappers, plain PyTorch versions and the numpy golden.

Port of google_nerf_tpu/ops/pallas/brick_field.py `brick_field_tiles_wl`
(K1) and `brick_field_tiles_tp` (K2).  Both compute the function that
`brick_field_tiles_reference` defines: per 8x8 ray tile, its list of
bricks is composited front to back, each brick contributing the baked
field (brick-local trilerp of 8 corners x 16 features, sigma from h0,
rgb from the 32->64->64->3 MLP on [sh16, h16]) with tau carried across
bricks and the live gate tau < tau_max.

The CUDA kernels live in csrc/brick_field.cu and are built with nvcc on
first use into build/kernels/ (a plain C interface loaded with ctypes).
A wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback between the two.

Differences from the JAX entries:
  * the pool is the baked row layout (n_blocks, Bk^3, 128), not the
    TPU's transposed (n_blocks, 128, Bk^3) copy;
  * `out` (optional) receives the result in place: it starts as a copy
    of `init` (zeros if None) and only visited tiles change, so every
    output row is defined, where JAX left unvisited tiles undefined;
  * the JAX cost-estimate-only arguments inv2s/V are not taken.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from google_nerf_tpu_torch.models.baked import trilerp_w8
from google_nerf_tpu_torch.ops.ray_aabb import safe_inverse

TPX = 64          # rays per tile (8x8)
ROWW = 128        # pool row lanes (8 corners x 16 features)
FEAT = 16
MAX_S = 64        # window span the kernels' shared-memory layout allows

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "brick_field.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC")
_lib_handle = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the brick-field kernels build "
                           "only where the CUDA toolkit is installed")
    return nvcc


def build() -> Path:
    """Compile csrc/brick_field.cu for sm_90a into build/kernels/ unless a
    library of the same source and flags is there.  Returns its path; the
    compiler's log (ptxas register and spill report) sits beside it."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"libbrick_field_{key}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_float)
        head = [p, p, i64, p, p, p, i64, p, p, p, p, i32]
        lib.brick_field_wl.argtypes = head + [p, p, p, p, i32, i32, i32, f32,
                                              f32, i32, p]
        lib.brick_field_tp.argtypes = head + [p, p, p, i32, i32, i32, f32,
                                              f32, i32, p]
        lib.brick_field_wl.restype = lib.brick_field_tp.restype = i32
        lib.brick_field_error_string.argtypes = [i32]
        lib.brick_field_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def window_span(max_samples: int, block: int, voxel_res: int,
                scale: float) -> int:
    """Longest lattice window inside one brick (the S of the kernels)."""
    s = min(0.5, scale)
    vox_w = 2.0 * s / voxel_res
    dt = math.sqrt(3.0) / max_samples
    return int(math.ceil(block * vox_w * math.sqrt(3.0) / dt)) + 1


# ---------------------------------------------------------------- golden

def brick_field_tiles_reference(pool_blk, meta, rays, sh, pool3, w1,
                                w2, w3, *, S, dt, inv2s, V, tau_max,
                                tid=None, lbase=None, nslots=None,
                                Bk: int = 8):
    """Pure-numpy restatement of the kernel semantics (copy of the JAX
    package's golden): same slot order, early-termination rule and
    tid/lbase/nslots list addressing; f32/f64 arithmetic throughout."""
    pool_blk = np.asarray(pool_blk)
    meta = np.asarray(meta, np.float32)
    rays = np.asarray(rays, np.float32)
    sh = np.asarray(sh, np.float32)
    pool3 = np.asarray(pool3, np.float32)
    w1, w2, w3 = (np.asarray(w, np.float32) for w in (w1, w2, w3))
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
            m = meta[int(lbase[b]) + l]
            inv_d = 1.0 / np.where(np.abs(du) > 1e-10, du,
                                   np.where(du >= 0, 1e-10, -1e-10))
            t_lo = (m[0:3][None] - o) * inv_d
            t_hi = (m[3:6][None] - o) * inv_d
            ta = np.maximum(np.minimum(t_lo, t_hi).max(1), t1)
            tb = np.minimum(np.maximum(t_lo, t_hi).min(1), t2)
            n0 = np.maximum(np.ceil((ta - t1) / dt - 0.5), 0.0)
            n1 = np.floor((tb - t1) / dt - 0.5)
            hit = (tb > ta) & (n1 >= n0) & (t2 > 0)
            tau_tot = out[sl, 0]
            live = tau_tot < tau_max
            if not np.any(hit & live):
                continue
            slab = pool3[pool_blk[int(lbase[b]) + l]]      # (vox, 128)
            tau_c = np.zeros(TPX)
            rgbw = np.zeros((TPX, 3))
            depw = np.zeros(TPX)
            for s in range(S):
                n_s = n0 + s
                s_ok = hit & (n_s <= n1)
                ts = t1 + (n_s + 0.5) * dt
                xyz = o + ts[:, None] * du
                u = np.clip((xyz - m[0:3][None]) * Bk
                            / (m[3:6] - m[0:3])[None], 0.0, Bk - 1e-3)
                v0 = np.floor(u)
                frac = u - v0
                lid = ((v0[:, 0] * Bk + v0[:, 1]) * Bk
                       + v0[:, 2]).astype(np.int64)
                rows = slab[lid].reshape(TPX, 8, FEAT)
                w8 = np.ones((TPX, 8))
                for k in range(3):
                    bit = (np.arange(8)[None] >> k) & 1
                    w8 = w8 * np.where(bit == 1, frac[:, k:k + 1],
                                       1.0 - frac[:, k:k + 1])
                h = np.einsum("nc,ncf->nf", w8, rows)
                sd = np.where(s_ok,
                              np.exp(np.minimum(h[:, 0], 30.0)) * dt, 0.0)
                sd = np.minimum(sd, 80.0)
                a = np.maximum(np.concatenate([sh[sl], h], 1) @ w1, 0.0)
                a = np.maximum(a @ w2, 0.0)
                rgb_s = 1.0 / (1.0 + np.exp(-(a @ w3)))
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


# ---------------------------------------------------------- plain versions

def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the TPU kernel's operand casts."""
    return x.to(torch.bfloat16).float()


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


def _slot_step(st, rays, sh, meta_rows, pb, valid, pool3, w1b, w2b, w3b, *,
               S, dt, tau_max, Bk):
    """Composite one list slot into the carried state of B tiles.

    st (B, 64, 8) f32 state, updated in place; rays (B, 64, 8); sh
    (B, 64, 16); meta_rows (B, 8); pb (B,) pool block; valid (B,) bool.
    Vectorized over tiles, rays and window samples; arithmetic in the
    kernel's order and rounding (bf16 slab, bf16-rounded corner products
    and MLP operands, f32 accumulation)."""
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
    rows = _bf(pool3[pb[bi], lid]).reshape(-1, 8, FEAT)
    h = _bf(trilerp_w8(u - v0)[..., None] * rows).sum(-2)        # (M, 16)
    sd = torch.clamp_max(torch.exp(torch.clamp_max(h[:, 0], 30.0)) * dt_t,
                         80.0)
    a1 = torch.relu(_bf(sh[bi, ri]) @ w1b[:FEAT] + _bf(h) @ w1b[FEAT:])
    a2 = torch.relu(_bf(a1) @ w2b)
    rgb = torch.sigmoid(_bf(a2) @ w3b)

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


def _tp_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid, lbase,
              nslots, out, *, S, dt, tau_max, Lcall, Bk):
    """Tiles tid[b] walk list rows lbase[b] + l, l < nslots[b], from the
    state already in `out` (which holds init)."""
    T = rays.shape[0] // TPX
    n_rows = meta.shape[0]
    tid_l = tid.long()
    st = out.view(T, TPX, 8)[tid_l].clone()
    r = rays.view(T, TPX, 8)[tid_l]
    shv = sh.view(T, TPX, FEAT)[tid_l]
    wb = [_bf(w) for w in (w1, w2, w3)]
    for l in range(Lcall):
        valid = l < nslots
        if not bool(valid.any()):
            break
        rows = (lbase.long() + l).clamp(0, n_rows - 1)
        _slot_step(st, r, shv, meta[rows], pool_blk[rows].long(), valid,
                   pool3, *wb, S=S, dt=dt, tau_max=tau_max, Bk=Bk)
    out.view(T, TPX, 8)[tid_l] = st
    return out


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
    shv = sh.view(T, TPX, FEAT)[tid_l]
    wb = [_bf(w) for w in (w1, w2, w3)]
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
            _slot_step(st, r, shv, meta[rows], pool_blk[rows].long(), valid,
                       pool3, *wb, S=S, dt=dt, tau_max=tau_max, Bk=Bk)
    out.view(T, TPX, 8)[tid_l] = st
    return out


# ------------------------------------------------------ argument handling

def _check(name, t, device, dtype=None, shape=None):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, pool3 on {device}")
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


def _prepare(pool_blk, meta, rays, sh, pool3, w1, w2, w3, S, Bk, init, out):
    """Checks shared by both kernels; returns (T, pool_blk int32, out)."""
    dev = pool3.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no brick-field kernel for device {dev}")
    if pool3.ndim != 3 or tuple(pool3.shape[1:]) != (Bk ** 3, ROWW):
        raise ValueError(f"pool3: shape {tuple(pool3.shape)}, expected "
                         f"(n_blocks, {Bk ** 3}, {ROWW})")
    _check("pool3", pool3, dev,
           torch.bfloat16 if dev.type == "cuda" else None)
    if dev.type == "cuda" and pool3.data_ptr() % 16:
        raise ValueError("pool3 must be 16-byte aligned")
    if not 1 <= S <= MAX_S:
        raise ValueError(f"window span S={S} outside [1, {MAX_S}]")
    if rays.ndim != 2 or rays.shape[0] % TPX or rays.shape[1] != 8:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected "
                         f"(T*{TPX}, 8)")
    T = rays.shape[0] // TPX
    n_rows = meta.shape[0]
    for name, t, shape in (("rays", rays, None), ("meta", meta, (n_rows, 8)),
                           ("sh", sh, (T * TPX, FEAT)), ("w1", w1, (32, 64)),
                           ("w2", w2, (64, 64)), ("w3", w3, (64, 3))):
        _check(name, t, dev, torch.float32, shape)
    pool_blk = _index("pool_blk", pool_blk, dev, n_rows)
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
    T, pool_blk, out = _prepare(pool_blk, meta, rays, sh, pool3, w1, w2, w3,
                                S, Bk, init, out)
    Ns = wt.shape[0]
    wt, wl, wn, wf = (_index(n, x, pool3.device, Ns) for n, x in
                      (("wt", wt), ("wl", wl), ("wn", wn), ("wf", wf)))
    return T, pool_blk, wt, wl, wn, wf, out


def _prepare_tp(pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid, lbase,
                nslots, Lcall, P, S, Bk, init, out):
    T, pool_blk, out = _prepare(pool_blk, meta, rays, sh, pool3, w1, w2, w3,
                                S, Bk, init, out)
    dev = pool3.device
    Lp = meta.shape[0] // T
    tid = (torch.arange(T, device=dev) if tid is None
           else torch.as_tensor(tid, device=dev))
    Tb = tid.shape[0]
    tid = _index("tid", tid, dev, Tb)
    lbase = _index("lbase", tid * Lp if lbase is None else lbase, dev, Tb)
    nslots = _index("nslots", torch.full((Tb,), Lp) if nslots is None
                    else nslots, dev, Tb)
    Lcall = Lcall or Lp
    if Lcall % P:
        raise ValueError(f"Lcall={Lcall} is not a multiple of P={P}")
    # checks on device values: on CUDA a device-side assert, so the host
    # does not wait for the queue (it fails at the next sync instead)
    st = torch.sort(tid).values
    _assert_values((lbase % P == 0).all(),
                   f"every lbase must be a multiple of P={P}")
    _assert_values((st[1:] != st[:-1]).all(), "tid entries must be distinct")
    return T, pool_blk, tid, lbase, nslots, Lcall, out


def _assert_values(ok: torch.Tensor, msg: str):
    if ok.is_cuda:
        torch._assert_async(ok, msg)
    elif not bool(ok):
        raise ValueError(msg)


def _raise_on(err: int, what: str):
    if err:
        msg = _lib().brick_field_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


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
    err = _lib().brick_field_wl(
        _ptr(pool_blk), _ptr(meta), meta.shape[0], _ptr(rays), _ptr(sh),
        _ptr(pool3), pool3.shape[0], _ptr(w1), _ptr(w2), _ptr(w3), _ptr(out),
        T, _ptr(wt), _ptr(wl), _ptr(wn), _ptr(wf), wt.shape[0], P, S, dt,
        tau_max, Bk, _stream(pool3.device))
    _raise_on(err, "brick_field_wl")
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
        return _tp_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid,
                         lbase, nslots, out, S=S, dt=dt, tau_max=tau_max,
                         Lcall=Lcall, Bk=Bk)
    if tid.shape[0] == 0:
        return out
    err = _lib().brick_field_tp(
        _ptr(pool_blk), _ptr(meta), meta.shape[0], _ptr(rays), _ptr(sh),
        _ptr(pool3), pool3.shape[0], _ptr(w1), _ptr(w2), _ptr(w3), _ptr(out),
        T, _ptr(tid), _ptr(lbase), _ptr(nslots), tid.shape[0], Lcall, S, dt,
        tau_max, Bk, _stream(pool3.device))
    _raise_on(err, "brick_field_tp")
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
    return _tp_plain(pool_blk, meta, rays, sh, pool3, w1, w2, w3, tid, lbase,
                     nslots, out, S=S, dt=dt, tau_max=tau_max, Lcall=Lcall,
                     Bk=Bk)
