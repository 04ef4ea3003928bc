"""zlib decompression of ScanNet .sens depth frames through the port's
C++ helper (port of google_nerf_tpu/scannet_tools/native.py).

csrc/sens_decode.cpp builds at first use with the host C++ compiler
(ops/cuda/_build.py, into build/kernels/) and loads with ctypes; a
failed build raises, where JAX's falls back to Python's zlib.  As in
JAX, a single buffer the helper cannot decompress is handed to Python's
zlib, which decompresses it or raises zlib.error, and a batch with a
buffer that fails raises ValueError.
"""
from __future__ import annotations

import ctypes
import os
import zlib
from typing import List

import numpy as np

from google_nerf_tpu_torch.ops.cuda import _build


def _declare(lib):
    i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    lib.sens_zlib_decompress.restype = i64
    lib.sens_zlib_decompress.argtypes = [ctypes.c_char_p, i64, u8p, i64]
    lib.sens_zlib_decompress_batch.restype = i64
    lib.sens_zlib_decompress_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), i64, u8p,
        i64, ctypes.POINTER(i64), i64]


def library() -> ctypes.CDLL:
    """csrc/sens_decode.cpp's library, built at first use."""
    return _build.load("sens_decode", _declare)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def zlib_decompress(data: bytes, max_size: int = 32 << 20) -> bytes:
    """One zlib buffer -> its bytes (at most max_size of them through the
    helper; a larger or corrupt stream goes to Python's zlib)."""
    out = np.empty(max_size, np.uint8)
    n = library().sens_zlib_decompress(data, len(data), _u8(out), max_size)
    if n < 0:
        return zlib.decompress(data)
    return out[:n].tobytes()


def zlib_decompress_batch(buffers: List[bytes], item_size: int,
                          n_threads: int = 0) -> np.ndarray:
    """Decompress many equal-size buffers in parallel -> (n, item_size)
    uint8 array (bulk decoding of .sens depth streams); n_threads <= 0
    takes min(cores, 16).  Raises ValueError if any buffer fails."""
    n = len(buffers)
    out = np.empty((n, item_size), np.uint8)
    lib = library()
    srcs = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
    outlens = (ctypes.c_int64 * n)()
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    failed = lib.sens_zlib_decompress_batch(srcs, lens, n, _u8(out),
                                            item_size, outlens, n_threads)
    if failed:
        raise ValueError(f"{failed} buffers failed to decompress")
    return out
