"""The construct ladder P5: the wrapper of the 17 rungs in csrc/ladder.cu,
each rung's plain PyTorch version, and the JAX tool's operands.

Port of tools/mosaic_bisect.py (`run` :19-31, rungs k1-k17 :40-186): 17
minimal kernels, each adding one construct of the transposed tile kernel
and each writing an (8, 64) f32 block.  `rung(k, *operands)` launches rung
k for CUDA tensors and takes its plain version only for CPU tensors;
`rung.launches` counts the ladder's kernel launches.  The four long rungs
(k6, k7, k8, k17) run over a grid whose last block sums the blocks'
partials, still one launch each; the partials and the ticket that finds
the last block are the library's own, so launches of one rung must not
overlap (the ladder runs on one stream).

The one definition that differs: k12 reads its output before writing it.
The JAX rung's output buffer is undefined there (interpret mode fills it
with NaN, so JAX returns NaN); here k12 starts from a zeroed output and
returns 1.0 everywhere.
"""
from __future__ import annotations

import ctypes

import torch

from google_nerf_tpu_torch.ops.cuda import _build

S, TPX, N, VOX, ROWW = 9, 64, 576, 512, 128
OUT_SHAPE = (8, TPX)
F32, BF16, I16 = torch.float32, torch.bfloat16, torch.int16

# rung: (the JAX tool's label, operands as (name, shape, dtype))
R8 = ("r8", (8, TPX), F32)
ROWV16 = ("rowv16", (VOX, N), I16)
RUNGS = {
    1: ("k1 (8,64) load/slice/store", (R8,)),
    2: ("k2 lane concat (1,64)x9", (R8,)),
    3: ("k3 (1,N) iota arith", (R8,)),
    4: ("k4 lane slices @64", (R8,)),
    5: ("k5 (1,N) bool/where", (R8,)),
    6: ("k6 (VOX,N) i32 onehot->bf16", (R8,)),
    7: ("k7 i16 rowv operand onehot", (R8, ROWV16)),
    8: ("k8 dot (128,512)@(512,N)", (("slabT", (ROWW, VOX), BF16),)),
    9: ("k9 (16,64) block + tile", (("sh", (16, TPX), F32),)),
    10: ("k10 (64,32)@(32,N) dot", (("w1", (64, 32), BF16),)),
    11: ("k11 (3,ROWW,N) operand slice", (("bitw", (3, ROWW, N), F32),)),
    12: ("k12 out row read + when", (R8,)),
    13: ("k13 (1,N)->(ROWW,N) bcast", (R8,)),
    14: ("k14 bool lane tile + scalar mix", (R8,)),
    15: ("k15 (1,1) splats from (1,8)", (("meta", (1, 1, 8), F32),)),
    16: ("k16 exp/sigmoid (1,N)/(3,N)", (R8,)),
    17: ("k17 i16 load upcast cmp", (ROWV16,)),
}
# Relative tolerance of a rung against its plain version: f32 sums in
# another order, exp and sigmoid.  Every other rung's sums are integers
# below 2^24, exact in any order.
RTOL = {13: 1e-5, 15: 1e-5, 16: 1e-5}


def mismatch(k: int, got: torch.Tensor, want: torch.Tensor) -> str | None:
    """Why rung k's output `got` fails against `want` (its plain
    version's) at the rung's tolerance, or None if it agrees."""
    if tuple(got.shape) != OUT_SHAPE or got.dtype != F32:
        return f"{got.dtype} of shape {tuple(got.shape)}"
    if not bool(torch.isfinite(got).all()):
        return "output not finite"
    rtol = RTOL.get(k, 0.0)
    bad = (got - want).abs() > rtol * want.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        return (f"{float(got.flatten()[i])} vs plain "
                f"{float(want.flatten()[i])} (rtol {rtol})")
    return None


def operands(device="cuda") -> dict[str, torch.Tensor]:
    """The JAX tool's literal operands (mosaic_bisect.py:36, :88, :98,
    :108, :116, :126, :160, :180): ones, iotas and an arange."""
    iota16 = torch.arange(VOX, dtype=I16, device=device)[:, None]
    return {"r8": torch.ones(8, TPX, device=device),
            "rowv16": iota16.expand(VOX, N).contiguous(),
            "slabT": torch.ones(ROWW, VOX, dtype=BF16, device=device),
            "sh": torch.ones(16, TPX, device=device),
            "w1": torch.ones(64, 32, dtype=BF16, device=device),
            "bitw": torch.ones(3, ROWW, N, device=device),
            "meta": torch.arange(8, dtype=F32, device=device).reshape(1, 1,
                                                                      8)}


def rung_operands(k: int, ops: dict) -> list[torch.Tensor]:
    """Rung k's operands, in order, from an operands() dict."""
    return [ops[name] for name, _, _ in RUNGS[k][1]]


# ------------------------------------------------------- plain versions

def _fill(v: torch.Tensor) -> torch.Tensor:
    return torch.zeros(OUT_SHAPE, device=v.device) + v


def _iota(shape, dim, device, dtype=torch.int32):
    size = [1] * len(shape)
    size[dim] = shape[dim]
    return torch.arange(shape[dim], dtype=dtype, device=device).reshape(
        size).expand(shape)


def _onehot_sum(eq: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=BF16, device=eq.device)
    return _fill(torch.where(eq, one, 0 * one).float().sum())


def _plain(k, x, y=None):
    dev = x.device
    n = _iota((1, N), 1, dev)
    if k == 1:
        return x + x[0:1]
    if k == 2:
        return _fill(torch.cat([x[6:7]] * S, 1).sum())
    if k == 3:
        return _fill(((n // TPX).float() * 2.0 + 1.0).sum())
    if k == 4:
        s_n = n.float()
        acc = torch.zeros((1, TPX), device=dev)
        for si in range(S):
            acc = acc + s_n[:, si * TPX:(si + 1) * TPX]
        return _fill(acc[0:1])
    if k == 5:
        return _fill(torch.where((n > 5) & (n < 500), 1.0, 0.0).sum())
    if k == 6:
        return _onehot_sum(_iota((VOX, N), 0, dev) == n % VOX)
    if k == 7:
        return _onehot_sum(y == (n % VOX).to(I16))
    if k == 8:
        oh = torch.where(_iota((VOX, N), 0, dev) == 3, 1.0, 0.0).to(BF16)
        return _fill((x.float() @ oh.float()).sum())
    if k == 9:
        return _fill(torch.cat([x] * S, 1).sum())
    if k == 10:
        ones = torch.ones((32, N), dtype=BF16, device=dev)
        return _fill(torch.relu(x.float() @ ones.float()).sum())
    if k == 11:
        return _fill((x[0] * 2.0 + x[1]).sum())
    if k == 12:
        o = torch.zeros(OUT_SHAPE, device=dev)
        live = o[0:1] < 4.6
        return o + torch.where(live, 1.0, 0.0) if bool(live.any()) else o
    if k == 13:
        f = n.float() * 0.01
        return _fill((torch.ones((ROWW, N), device=dev)
                      * ((1.0 - f) + 0.5 * (2.0 * f - 1.0))).sum())
    if k == 14:
        big = torch.cat([x[0:1] > 0.5] * S, 1)
        return _fill(torch.where(big & (x[1, 0] > 0.0), 1.0, 0.0).sum())
    if k == 15:
        m = x[0]
        acc = torch.zeros((1, TPX), device=dev)
        for j in range(3):
            acc = acc + (m[0:1, j:j + 1] - 0.3) * 2.0
        return _fill(acc)
    if k == 16:
        v = n.float() * 1e-3
        sd = torch.exp(-v) * (1.0 - torch.exp(-v))
        sg = torch.sigmoid(torch.ones((3, N), device=dev) * v)
        return _fill(sd.sum() + sg.sum())
    return _onehot_sum(x.int() == 3)                       # k17


def _check(k, args):
    if k not in RUNGS:
        raise ValueError(f"no rung k{k}: the ladder has k1-k{len(RUNGS)}")
    spec = RUNGS[k][1]
    if len(args) != len(spec):
        raise TypeError(f"k{k} takes {len(spec)} operand(s), got "
                        f"{len(args)}")
    dev = args[0].device if torch.is_tensor(args[0]) else None
    for t, (name, shape, dtype) in zip(args, spec):
        if not torch.is_tensor(t) or t.dtype != dtype or \
                tuple(t.shape) != shape:
            raise TypeError(f"k{k} {name}: expected {dtype} of shape {shape}")
        if t.device != dev or dev.type not in ("cpu", "cuda"):
            raise ValueError(f"k{k} {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"k{k} {name} must be contiguous")


def rung_plain(k: int, *args: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of rung k on any device: the JAX rung's
    computation on the same operands, (8, 64) f32."""
    _check(k, args)
    return _plain(k, *args)


# ----------------------------------------------------------------- kernel

def _declare(lib):
    p = ctypes.c_void_p
    lib.ladder_rung.argtypes = [ctypes.c_int, p, p, p, p]
    lib.ladder_rung.restype = ctypes.c_int
    lib.ladder_error_string.argtypes = [ctypes.c_int]
    lib.ladder_error_string.restype = ctypes.c_char_p


def rung(k: int, *args: torch.Tensor) -> torch.Tensor:
    """Rung k (1-17) on its operands (RUNGS[k]; operands() has the JAX
    tool's): the kernel on CUDA tensors, the plain version on CPU ones.
    Returns (8, 64) f32."""
    _check(k, args)
    dev = args[0].device
    if dev.type == "cpu":
        return _plain(k, *args)
    out = torch.zeros(OUT_SHAPE, device=dev)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args] + [None]
    with torch.cuda.device(dev):
        lib = _build.load("ladder", _declare)
        err = lib.ladder_rung(
            k, ptrs[0], ptrs[1], ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        msg = lib.ladder_error_string(err).decode()
        raise RuntimeError(f"ladder rung k{k} launch failed: {msg} ({err})")
    rung.launches += 1
    return out


rung.launches = 0
