"""The depth decoder's 3x3 convolution on the card: the wrapper of
csrc/conv3x3.cu.

No TPU kernel is ported here: the JAX package leaves its convolutions
to XLA.  `conv3x3(x, weight, bias)` computes, for CUDA tensors, the
stride-1, padding-1 NCHW float32 convolution as an implicit GEMM on the
FP32 cores (each output a direct f32 sum of its Cin x 9 products; no
TF32, FFT or Winograd), and for CPU tensors runs the plain version
(ops/conv3x3.conv3x3_plain).  Both refuse alike what the kernels do not
take; there is no fallback between the two.

A call on the card launches, on the current stream, the weights' repack
into the GEMM's (9, Cp, Np) layout, the GEMM and, where the output map
is too small to fill the card, the fixed-order sum of the split over K
(`plan`); Cout = 1 takes its own per-pixel kernel instead of the GEMM.
It allocates with torch.empty only, reads nothing back and does not
synchronise, so CUDA graphs capture it (depth/priors.py).  `launches`
counts kernel launches; the counter `depth_conv3_macs`
(utils/logging.count) the multiply-adds the kernels did.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from google_nerf_tpu_torch.ops.conv3x3 import check, conv3x3_plain
from google_nerf_tpu_torch.ops.cuda import _build
from google_nerf_tpu_torch.utils.logging import count

BM, BN, BK, PACK_C = 128, 128, 16, 32    # csrc/conv3x3.cu's tiles
MIN_STEPS = 16         # the fewest K steps (of BK) a split is given
MAX_M_TILES = 65535    # the grid's y dimension


def _declare(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.conv3x3_pack_weights.argtypes = [p, i32, i32, i32, i32, p, p]
    lib.conv3x3_gemm_launch.argtypes = [p, p, p] + [i32] * 9 + [p, p]
    lib.conv3x3_reduce_launch.argtypes = [p, i32, i64, i64, i32, p, p, p]
    lib.conv3x3_cout1_launch.argtypes = [p, p, p, i32, i32, i32, i32, p, p]
    for name in ("conv3x3_pack_weights", "conv3x3_gemm_launch",
                 "conv3x3_reduce_launch", "conv3x3_cout1_launch",
                 "conv3x3_tiles"):
        getattr(lib, name).restype = ctypes.c_int
    lib.conv3x3_tiles.argtypes = [ctypes.c_int]
    lib.conv3x3_error_string.argtypes = [ctypes.c_int]
    lib.conv3x3_error_string.restype = ctypes.c_char_p
    if tuple(lib.conv3x3_tiles(i) for i in range(4)) != (BM, BN, BK, PACK_C):
        raise RuntimeError("csrc/conv3x3.cu and ops/cuda/conv3x3.py "
                           "disagree on the tiles")


def _lib():
    return _build.load("conv3x3", _declare)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(B: int, C: int, H: int, W: int, N: int, sms: int) -> dict:
    """The launch of one convolution on a card of `sms` SMs: the packed
    weights' padded sizes Cp (a multiple of 32) and Np (of BN), the
    split over K and its K steps a split.  Below two blocks an SM, K is
    split as far as that fills the card, each split at least MIN_STEPS
    steps of BK channels at one tap; the splits are then evened out."""
    M = B * H * W
    tiles = -(-M // BM) * -(-N // BN)
    steps = 9 * -(-C // BK)
    splits = max(1, min(2 * sms // tiles, steps // MIN_STEPS))
    per_split = -(-steps // splits)
    return dict(Cp=-(-C // PACK_C) * PACK_C, Np=-(-N // BN) * BN,
                splits=-(-steps // per_split), per_split=per_split)


def _launch(lib, name, *cargs):
    err = getattr(lib, name)(*cargs)
    if err:
        msg = lib.conv3x3_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    conv3x3.launches += 1


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None, stride=1,
            padding=1) -> torch.Tensor:
    """(B, Cout, H, W) float32 = bias + the 3x3, stride-1, padding-1
    convolution of x (B, Cin, H, W) with weight (Cout, Cin, 3, 3): the
    kernels for CUDA tensors, the plain version for CPU ones."""
    check(x, weight, bias, stride, padding)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no 3x3 convolution kernel for device {x.device}")
    B, C, H, W = x.shape
    N = weight.shape[0]
    M = B * H * W
    if M >= 2 ** 31 or -(-M // BM) > MAX_M_TILES:
        raise ValueError(f"{M} output pixels: at most {MAX_M_TILES * BM}")
    out = torch.empty((B, N, H, W), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _lib()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if N == 1:
            _launch(lib, "conv3x3_cout1_launch", _ptr(x), _ptr(weight),
                    _ptr(bias), B, C, H, W, _ptr(out), stream)
        else:
            p = plan(B, C, H, W, N, _sms(x.device.index or 0))
            wt = torch.empty((9, p["Cp"], p["Np"]), dtype=torch.float32,
                             device=x.device)
            _launch(lib, "conv3x3_pack_weights", _ptr(weight), C, N,
                    p["Cp"], p["Np"], _ptr(wt), stream)
            s = p["splits"]
            part = out if s == 1 else torch.empty(
                (s, B, N, H, W), dtype=torch.float32, device=x.device)
            _launch(lib, "conv3x3_gemm_launch", _ptr(x), _ptr(wt),
                    _ptr(bias if s == 1 else None), B, C, H, W, N, p["Cp"],
                    p["Np"], s, p["per_split"], _ptr(part), stream)
            if s > 1:
                _launch(lib, "conv3x3_reduce_launch", _ptr(part), s,
                        out.numel(), H * W, N, _ptr(bias), _ptr(out), stream)
    count("depth_conv3_macs", M * N * C * 9)
    return out


conv3x3.launches = 0
