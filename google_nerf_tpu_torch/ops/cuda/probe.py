"""Tool probes P1-P4: wrappers of the kernels in csrc/probe.cu and their
plain PyTorch versions.

Port of the Pallas probes in tools/pallas_probe.py:
  P1 `call`  (:42)  row gather from a VMEM-held f32 table;
  P2 `callb` (:77)  the same on a bf16 table;
  P3 `scall` (:123) row scatter-add in one scalar loop;
  P4 `ccall` (:167) row gather by one DMA per grid step.
P1 and P2 are `gather_rows` (one kernel template; its launches are
counted per table dtype), P3 is `scatter_add_rows` and P4
`gather_rows_bulk`.  Indices are int32, as JAX's are.

A wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback between the two.  Both
check their arguments alike, so a row that a gather cannot take (both
move 16-byte words) is refused on either device.
"""
from __future__ import annotations

import ctypes

import torch

from google_nerf_tpu_torch.ops.cuda import _build

GATHER_DTYPES = (torch.float32, torch.bfloat16)
BULK_MAX_ROW_BYTES = 512      # csrc/probe.cu: a warp's 32 rows in 16 KiB


def _declare(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for name in ("probe_gather_rows", "probe_gather_rows_bulk"):
        getattr(lib, name).argtypes = [p, i32, i32, p, i64, p, p]
    lib.probe_scatter_add_rows.argtypes = [p, i64, p, i32, p, i32, p]
    for name in ("probe_gather_rows", "probe_gather_rows_bulk",
                 "probe_scatter_add_rows", "probe_bulk_max_row_bytes"):
        getattr(lib, name).restype = ctypes.c_int
    lib.probe_bulk_max_row_bytes.argtypes = []
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    if lib.probe_bulk_max_row_bytes() != BULK_MAX_ROW_BYTES:
        raise RuntimeError("csrc/probe.cu and ops/cuda/probe.py disagree "
                           "on the bulk-copy row limit")


def _lib():
    return _build.load("probe", _declare)


def _launch(name, *cargs, dev):
    """Call the C entry `name` on dev's current stream; raise on error."""
    with torch.cuda.device(dev):
        lib = _lib()
        err = getattr(lib, name)(
            *cargs, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        msg = lib.probe_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_rows(tab, idx, dtypes, names=("tab", "idx")):
    """Shared checks: tab a contiguous 2-D table of one of `dtypes`, idx a
    contiguous 1-D int32 index on tab's device."""
    for name, t in zip(names, (tab, idx)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = tab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernel for device {dev}")
    if tab.ndim != 2 or tab.dtype not in dtypes:
        raise TypeError(f"{names[0]}: {tab.dtype} of shape "
                        f"{tuple(tab.shape)}, expected 2-D of {dtypes}")
    if idx.ndim != 1 or idx.dtype != torch.int32:
        raise TypeError(f"{names[1]}: {idx.dtype} of shape "
                        f"{tuple(idx.shape)}, expected 1-D int32")
    if idx.device != dev:
        raise ValueError(f"{names[1]} is on {idx.device}, {names[0]} on "
                         f"{dev}")
    if tab.shape[0] >= 2 ** 31:
        raise ValueError(f"{names[0]} has {tab.shape[0]} rows; at most "
                         "2^31 - 1")


def _check_gather(tab, idx, what, max_row_bytes):
    """_check_rows for a gather, whose kernel moves 16-byte words: a row
    must be a multiple of 16 bytes, at most max_row_bytes, and tab 16-byte
    aligned.  Returns the row size in bytes."""
    _check_rows(tab, idx, GATHER_DTYPES)
    row_bytes = tab.shape[1] * tab.element_size()
    if row_bytes % 16 or not 0 < row_bytes <= max_row_bytes:
        raise ValueError(f"rows of {row_bytes} bytes: {what} takes a "
                         f"multiple of 16 bytes, here at most "
                         f"{max_row_bytes}")
    if tab.data_ptr() % 16:
        raise ValueError(f"tab must be 16-byte aligned for {what}")
    return row_bytes


# ------------------------------------------------------------ P1 and P2

def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1 (f32 table) and P2 (bf16 table): out[i] = tab[idx[i]].

    tab (T, F) float32 or bfloat16, 16-byte aligned with rows a multiple
    of 16 bytes (others raise ValueError on every device), idx (N,) int32
    in [0, T); returns (N, F) of tab's dtype.  On CUDA an index outside the
    table trips a device-side assert.  `gather_rows.launches` counts kernel
    launches per table dtype ("float32", "bfloat16")."""
    row_bytes = _check_gather(tab, idx, "the gather", 2 ** 31 - 16)
    if tab.device.type == "cpu":
        return gather_rows_plain(tab, idx)
    n = idx.shape[0]
    if n * row_bytes >= 2 ** 36:
        raise ValueError(f"gather of {n} rows of {row_bytes} bytes: the "
                         "output must be under 64 GiB")
    out = torch.empty((n, tab.shape[1]), dtype=tab.dtype, device=tab.device)
    if n:
        _launch("probe_gather_rows", _ptr(tab), tab.shape[0], row_bytes,
                _ptr(idx), n, _ptr(out), dev=tab.device)
        gather_rows.launches[str(tab.dtype).split(".")[1]] += 1
    return out


gather_rows.launches = {"float32": 0, "bfloat16": 0}


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P1/P2 on any device (same contract)."""
    _check_gather(tab, idx, "the gather", 2 ** 31 - 16)
    return tab.index_select(0, idx)


# ------------------------------------------------------------------- P3

def _check_scatter(sidx, vals, T):
    _check_rows(vals, sidx, (torch.float32,), ("vals", "sidx"))
    if not 0 <= T < 2 ** 31:
        raise ValueError(f"T={T}: expected 0 <= T < 2^31")
    if sidx.shape[0] != vals.shape[0]:
        raise ValueError(f"sidx has {sidx.shape[0]} entries, vals "
                         f"{vals.shape[0]} rows")


def scatter_add_rows(sidx: torch.Tensor, vals: torch.Tensor,
                     T: int) -> torch.Tensor:
    """P3: out = zeros(T, F); out[sidx[i]] += vals[i] for every i.

    sidx (NS,) int32 in [0, T), vals (NS, F) float32; returns (T, F)
    float32.  On CUDA the C entry zeroes the output (a memset on the
    stream) and the kernel adds into it with atomics, 16 bytes a
    reduction where F and alignment allow, so the order of each row's
    sums, and its last bits, vary from run to run; an index outside
    [0, T) trips a device-side assert.  `launches` counts the kernel's
    launches: none when vals is empty (the memset alone)."""
    _check_scatter(sidx, vals, T)
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(sidx, vals, T)
    if vals.numel() >= 2 ** 31:
        raise ValueError(f"{vals.numel()} values: at most 2^31 - 1")
    out = torch.empty((T, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    if out.numel() or vals.numel():     # the entry zeroes out itself
        _launch("probe_scatter_add_rows", _ptr(sidx), sidx.shape[0],
                _ptr(vals), vals.shape[1], _ptr(out), T, dev=vals.device)
        scatter_add_rows.launches += vals.numel() > 0
    return out


scatter_add_rows.launches = 0


def scatter_add_rows_plain(sidx: torch.Tensor, vals: torch.Tensor,
                           T: int) -> torch.Tensor:
    """Plain PyTorch version of P3 on any device (same contract)."""
    _check_scatter(sidx, vals, T)
    out = torch.zeros((T, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, sidx, vals)


# ------------------------------------------------------------------- P4

def gather_rows_bulk(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P4: out[g] = tab[idx[g]], each row brought into shared memory by
    its own bulk copy (TMA), a warp's 32 rows on one mbarrier, and the
    warp's tile stored by one bulk copy.

    As gather_rows, with rows of at most 512 bytes; other rows raise
    ValueError on every device (the kernel never falls back)."""
    row_bytes = _check_gather(tab, idx, "a bulk copy", BULK_MAX_ROW_BYTES)
    if tab.device.type == "cpu":
        return gather_rows_bulk_plain(tab, idx)
    n = idx.shape[0]
    out = torch.empty((n, tab.shape[1]), dtype=tab.dtype, device=tab.device)
    if n:
        _launch("probe_gather_rows_bulk", _ptr(tab), tab.shape[0], row_bytes,
                _ptr(idx), n, _ptr(out), dev=tab.device)
        gather_rows_bulk.launches += 1
    return out


gather_rows_bulk.launches = 0


def gather_rows_bulk_plain(tab: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P4 on any device (same contract)."""
    _check_gather(tab, idx, "a bulk copy", BULK_MAX_ROW_BYTES)
    return tab.index_select(0, idx)
