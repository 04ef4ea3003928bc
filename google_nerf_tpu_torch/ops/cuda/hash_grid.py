"""The hash-grid encoder's kernels: wrappers of csrc/hash_grid.cu and
their plain PyTorch versions.

No TPU kernel is ported here: JAX computes the hash grid in XLA
(google_nerf_tpu/models/encoders.py).  The kernels compute, point by
point in registers, what models/encoders.hash_encode's plain path
computes as a chain of tensor ops:
  `hash_grid_encode`  the features (N, L*F) f32 from x (N, 3) and the
                      table in its gather dtype;
  `hash_grid_grads`   the f32 table gradient (L, T, F) and the gradient
                      of x (N, 3) from the features' gradient;
  `hash_grid_corners` every corner's table index and weight (L, 8, N), a
                      debug entry for the tests.
The plain versions are built from ops/hash_grid, the plain arithmetic
that hash_encode runs on CPU tensors; the kernels' features equal them
bit for bit.

The kernels are instantiated for rows of 2 features (every hash field of
the port) gathered in bf16 or f32.  A wrapper launches its kernel for
CUDA tensors and takes the plain version only for CPU tensors; there is
no fallback between the two.  Both check their arguments alike and
refuse a width or a dtype the kernels have no instance for.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from google_nerf_tpu_torch.ops.cuda import _build
from google_nerf_tpu_torch.ops.hash_grid import (corner_rows, corners,
                                                 encode)
from google_nerf_tpu_torch.ops.packed_hash import _corner_weight_grads

FEATURES = (2,)                               # F the kernels instantiate
GATHER_DTYPES = (torch.bfloat16, torch.float32)
MAX_LEVELS = 64                               # csrc/hash_grid.cu


def _declare(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.hash_grid_encode.argtypes = [p, i64, p, i32, i32, i32, i32, p, p, p]
    lib.hash_grid_grads.argtypes = [p, p, i64, p, i32, i32, i32, i32, p, p,
                                    p, p]
    lib.hash_grid_corners.argtypes = [p, i64, i32, i32, p, p, p, p]
    for name in ("hash_grid_encode", "hash_grid_grads", "hash_grid_corners",
                 "hash_grid_max_levels"):
        getattr(lib, name).restype = ctypes.c_int
    lib.hash_grid_max_levels.argtypes = []
    lib.hash_grid_error_string.argtypes = [ctypes.c_int]
    lib.hash_grid_error_string.restype = ctypes.c_char_p
    if lib.hash_grid_max_levels() != MAX_LEVELS:
        raise RuntimeError("csrc/hash_grid.cu and ops/cuda/hash_grid.py "
                           "disagree on the most levels")


def _lib():
    return _build.load("hash_grid", _declare)


def _launch(name, *cargs, dev):
    """Call the C entry `name` on dev's current stream; raise on error."""
    with torch.cuda.device(dev):
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*cargs, ctypes.c_void_p(stream))
    if err:
        msg = lib.hash_grid_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


@functools.lru_cache(maxsize=None)
def _res_array(res: tuple):
    return (ctypes.c_int32 * len(res))(*res)


def _check(x, res, T, tab=None):
    """x a contiguous (N, 3) f32; res a tuple of L resolutions in [1,
    2^24); T in [1, 2^31); tab, where given, a contiguous (L, T, F) table
    of a gather dtype with F in FEATURES, on x's device."""
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.ndim != 2 \
            or x.shape[1] != 3 or not x.is_contiguous():
        raise TypeError("x: expected a contiguous (N, 3) float32 tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hash-grid kernel for device {x.device}")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{x.shape[0]} points: at most 2^31 - 1")
    if not 0 < len(res) <= MAX_LEVELS or not all(
            isinstance(r, int) and 1 <= r < 2 ** 24 for r in res):
        raise ValueError(f"res={res}: 1 to {MAX_LEVELS} resolutions in "
                         "[1, 2^24)")
    if not 0 < T < 2 ** 31:
        raise ValueError(f"T={T}: expected 0 < T < 2^31")
    if tab is None:
        return
    if not torch.is_tensor(tab) or tab.dtype not in GATHER_DTYPES \
            or not tab.is_contiguous():
        raise TypeError(f"tab: expected a contiguous tensor of "
                        f"{GATHER_DTYPES}")
    if tab.ndim != 3 or tab.shape[:2] != (len(res), T) \
            or tab.shape[2] not in FEATURES:
        raise ValueError(f"tab of shape {tuple(tab.shape)}: expected "
                         f"({len(res)}, {T}, F), F in {FEATURES}")
    if tab.device != x.device:
        raise ValueError(f"tab is on {tab.device}, x on {x.device}")
    row = tab.shape[2] * tab.element_size()
    if tab.data_ptr() % min(row, 16):
        raise ValueError(f"tab must be aligned to {min(row, 16)} bytes")


def _dtype_name(tab):
    return str(tab.dtype).removeprefix("torch.")


# ------------------------------------------------------------------ forward

def hash_grid_encode(tab: torch.Tensor, x: torch.Tensor,
                     res: tuple) -> torch.Tensor:
    """Features (N, L*F) f32 of points x (N, 3) f32 on table tab (L, T, F)
    (bf16 or f32, the gather dtype), level l at resolution res[l]: per
    level the 8 corners of the point's cell, their rows widened to f32,
    trilinearly summed.  `launches` counts kernel launches."""
    _check(x, res, tab.shape[1] if tab.ndim == 3 else 0, tab)
    if x.device.type == "cpu":
        return hash_grid_encode_plain(tab, x, res)
    L, T, F = tab.shape
    n = x.shape[0]
    out = torch.empty((n, L * F), dtype=torch.float32, device=x.device)
    if n:
        _launch("hash_grid_encode", _ptr(x), n, _ptr(tab),
                tab.element_size(), L, T, F, _res_array(tuple(res)),
                _ptr(out), dev=x.device)
        hash_grid_encode.launches += 1
    return out


hash_grid_encode.launches = 0


def hash_grid_encode_plain(tab, x, res):
    """Plain PyTorch version of hash_grid_encode (same contract)."""
    _check(x, res, tab.shape[1] if tab.ndim == 3 else 0, tab)
    return encode(tab, x, tuple(res), _dtype_name(tab))


# ----------------------------------------------------------------- backward

def _check_grads(g, x, tab, res, shape, table_grad, x_grad):
    L, T, F = shape
    _check(x, res, T, tab if x_grad else None)
    if len(res) != L or F not in FEATURES:
        raise ValueError(f"shape {shape}: expected ({len(res)}, T, F), F in "
                         f"{FEATURES}")
    if x_grad and tab.shape != shape:
        raise ValueError(f"tab of shape {tuple(tab.shape)}, expected {shape}")
    if not torch.is_tensor(g) or g.dtype != torch.float32 \
            or g.shape != (x.shape[0], L * F) or not g.is_contiguous() \
            or g.device != x.device:
        raise TypeError(f"g: expected a contiguous ({x.shape[0]}, {L * F}) "
                        f"float32 tensor on {x.device}")


def hash_grid_grads(g, x, tab, res, shape, table_grad=True, x_grad=False):
    """The gradients of hash_grid_encode(tab, x, res) given g (N, L*F) f32,
    the features' gradient: (dtable, dx), each None unless asked for.

    dtable (L, T, F) f32 = shape's table gradient: row idx of level l
    sums w_c * g over the corners that land on it; on CUDA the C entry
    zeroes it and the kernel adds with atomics, so the order of each
    row's sums, and its last bits, vary from run to run.  dx (N, 3) f32 =
    sum over levels and corners of (g . row_c) dw_c/dfrac * res; it reads
    tab (the gather dtype's table), which may be None without x_grad.
    `launches` counts kernel launches."""
    _check_grads(g, x, tab, res, shape, table_grad, x_grad)
    if x.device.type == "cpu":
        return hash_grid_grads_plain(g, x, tab, res, shape, table_grad,
                                     x_grad)
    L, T, F = shape
    n = x.shape[0]
    dt = (torch.empty(shape, dtype=torch.float32, device=x.device)
          if table_grad else None)
    dx = (torch.empty((n, 3), dtype=torch.float32, device=x.device)
          if x_grad else None)
    if dt is not None or dx is not None:     # the entry zeroes them itself
        _launch("hash_grid_grads", _ptr(x), _ptr(g), n,
                _ptr(tab if x_grad else None),
                tab.element_size() if x_grad else 4, L, T, F,
                _res_array(tuple(res)), _ptr(dt), _ptr(dx), dev=x.device)
        hash_grid_grads.launches += n > 0
    return dt, dx


hash_grid_grads.launches = 0


def hash_grid_grads_plain(g, x, tab, res, shape, table_grad=True,
                          x_grad=False):
    """Plain PyTorch version of hash_grid_grads (same contract): the table
    gradient by zeros + index_add_ of the payloads w_c * g, dx by the
    corner weights' derivatives."""
    _check_grads(g, x, tab, res, shape, table_grad, x_grad)
    L, T, F = shape
    n = x.shape[0]
    idx, w, frac = corners(x, tuple(res), T)
    gl = g.reshape(n, L, F).permute(1, 0, 2)                     # (L, N, F)
    dt = dx = None
    if table_grad:
        lev = torch.arange(L, device=x.device)[:, None, None] * T
        payload = (w[..., None] * gl[:, None]).reshape(-1, F)
        dt = torch.zeros((L * T, F), dtype=torch.float32,
                         device=x.device).index_add_(
            0, (idx + lev).reshape(-1), payload).view(shape)
    if x_grad:
        rows = corner_rows(tab, idx, _dtype_name(tab))
        rg = (rows * gl[:, None]).sum(-1)                          # (L, 8, N)
        dfrac = (rg.permute(0, 2, 1)[..., None]
                 * _corner_weight_grads(frac)).sum(-2)             # (L, N, 3)
        r = torch.tensor(res, dtype=torch.float32, device=x.device)
        dx = (dfrac * r[:, None, None]).sum(0)
    return dt, dx


# -------------------------------------------------------------------- debug

def hash_grid_corners(x, res, T):
    """(idx (L, 8, N) int32, w (L, 8, N) f32): every corner's table index
    and weight as the kernels compute them.  `launches` counts kernel
    launches."""
    _check(x, res, T)
    if x.device.type == "cpu":
        return hash_grid_corners_plain(x, res, T)
    L, n = len(res), x.shape[0]
    idx = torch.empty((L, 8, n), dtype=torch.int32, device=x.device)
    w = torch.empty((L, 8, n), dtype=torch.float32, device=x.device)
    if n:
        _launch("hash_grid_corners", _ptr(x), n, L, T,
                _res_array(tuple(res)), _ptr(idx), _ptr(w), dev=x.device)
        hash_grid_corners.launches += 1
    return idx, w


hash_grid_corners.launches = 0


def hash_grid_corners_plain(x, res, T):
    """Plain PyTorch version of hash_grid_corners (same contract)."""
    _check(x, res, T)
    idx, w, _ = corners(x, tuple(res), T)
    return idx.to(torch.int32), w
