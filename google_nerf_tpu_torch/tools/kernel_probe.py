"""Probe the Hopper kernels P1-P4 that answer tools/pallas_probe.py's
questions on the card: a row gather from a table in device memory (f32
and bf16), a row scatter-add with atomics, and a row gather made of one
bulk copy (TMA) per row.

    python -m google_nerf_tpu_torch.tools.kernel_probe [--seed N] [--profile]

Sizes are the JAX tool's: a (65536, 32) table, 1M gathered rows, 131072
scattered rows, 16384 bulk-copied rows.  Each probe prints one line in
the JAX tool's form, `works=` (the kernel against its plain version:
gathers bitwise, the scatter within atol 1e-5), its ms and M rows/s,
with the times of the one-call PyTorch versions of the same function
beside it (`index_select` and `tab[idx]` for a gather, `index_add_` for
the scatter).  Times are means over REPS back-to-back calls by CUDA
events.  --profile adds each wrapper call's device time by
torch.profiler: every device op of one call (a fill included), each
op's mean per launch over PROFILE_REPS calls.  Runs on the card only;
exits 1 without one, or if a probe does not work.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import torch

from google_nerf_tpu_torch.ops.cuda import probe

T, F = 1 << 16, 32          # the table: 8 MiB in f32, 4 MiB in bf16
N = 1 << 20                 # rows gathered (P1, P2)
NS = 1 << 17                # rows scattered (P3)
NC = 1 << 14                # rows bulk-copied (P4)
REPS = 20                   # back-to-back calls per timing
PROFILE_REPS = 50           # calls per profiled timing (the profiler can
                            # miss a session's first launches)
SCATTER_ATOL = 1e-5         # ~2 N(0,1) rows land on each table row: an
                            # f32 sum in another order moves by a few ulp


@dataclass
class Probe:
    label: str              # the JAX tool's: (a), (a2), (b), (c)
    name: str               # the kernel's entry in chip_smoke's line
    what: str
    fn: Callable            # the wrapper
    plain: Callable         # its plain version
    args: tuple             # (tab, idx) for a gather, (sidx, vals, T)
    rows: int
    scatter: bool = False   # P3: atomic f32 sums, held within SCATTER_ATOL

    def library_calls(self) -> dict[str, Callable]:
        """The one-call PyTorch versions of the probe's function."""
        if self.scatter:
            sidx, vals, t = self.args
            return {"index_add_": lambda: torch.zeros(
                (t, vals.shape[1]), device=vals.device).index_add_(
                    0, sidx, vals)}
        tab, idx = self.args
        return {"index_select": lambda: tab.index_select(0, idx),
                "tab[idx]": lambda: tab[idx]}

    def agrees(self, got, want) -> tuple[bool, float]:
        """(works, max abs error) of a kernel's output against its plain
        version's: a gather bitwise, the scatter within SCATTER_ATOL."""
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        if self.scatter:
            return bool(torch.isfinite(got).all()) and err <= SCATTER_ATOL, \
                err
        return torch.equal(got, want), err

    def work(self) -> tuple[int, int]:
        """(bytes, f32 operations) the call must move and do on these
        inputs: each input read once (for a gather, the index and each
        distinct table row it touches), the output written once; the
        scatter's adds."""
        if self.scatter:
            sidx, vals, t = self.args
            return (4 * (sidx.numel() + vals.numel() + t * vals.shape[1]),
                    vals.numel())
        tab, idx = self.args
        row = tab.shape[1] * tab.element_size()
        return 4 * idx.numel() + row * (idx.numel()
                                        + torch.unique(idx).numel()), 0


def probes(device="cuda", seed=0, t=T, f=F, n=N, ns=NS,
           nc=NC) -> list[Probe]:
    """The four probes on seeded inputs at the given sizes."""
    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn(t, f, generator=g, device=device)
    idx = torch.randint(0, t, (n,), generator=g, device=device,
                        dtype=torch.int32)
    vals = torch.randn(ns, f, generator=g, device=device)
    sidx = torch.randint(0, t, (ns,), generator=g, device=device,
                         dtype=torch.int32)
    return [
        Probe("(a)", "gather_rows_f32", f"row gather f32, {n} x {f}",
              probe.gather_rows, probe.gather_rows_plain, (tab, idx), n),
        Probe("(a2)", "gather_rows_bf16", f"row gather bf16, {n} x {f}",
              probe.gather_rows, probe.gather_rows_plain,
              (tab.to(torch.bfloat16), idx), n),
        Probe("(b)", "scatter_add_rows", f"atomic scatter-add, {ns} x {f}",
              probe.scatter_add_rows, probe.scatter_add_rows_plain,
              (sidx, vals, t), ns, scatter=True),
        Probe("(c)", "gather_rows_bulk", f"bulk-copy row gather, {nc} rows",
              probe.gather_rows_bulk, probe.gather_rows_bulk_plain,
              (tab, idx[:nc]), nc),
    ]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps back-to-back runs after one warm-up, by
    CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> tuple[float, dict[str, tuple[float, int]]]:
    """(device ms of one call, {device op: (ms per launch, launches
    seen)}) by torch.profiler over reps back-to-back calls of fn after one
    warm-up.  The profiler can miss launches, so an op's time is its mean
    over the launches seen, and its launches per call its count over reps
    (rounded, at least 1)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = {e.key: (e.self_device_time_total / 1e3 / e.count, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0}
    return sum(ms * max(1, round(n / reps)) for ms, n in ops.values()), ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add each call's device time by torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device; the probes run "
                         "only on the card")
    failed = 0
    for p in probes("cuda", args.seed):
        ok, err = p.agrees(p.fn(*p.args), p.plain(*p.args))
        failed += not ok
        ms = cuda_ms(lambda: p.fn(*p.args), REPS)
        libs = "; ".join(f"{name} {cuda_ms(call, REPS):.4f} ms"
                         for name, call in p.library_calls().items())
        print(f"{p.label} cuda {p.what} works={ok} (max abs err {err:.1e}):"
              f" {ms:.4f} ms = {p.rows / ms / 1e3:.0f} M rows/s; {libs}",
              flush=True)
        if args.profile:
            call_ms, ops = device_ms(lambda: p.fn(*p.args), PROFILE_REPS)
            each = "; ".join(f"{k[:60]} {v:.5f} ms x{n}"
                             for k, (v, n) in ops.items())
            print(f"{p.label} device {call_ms:.5f} ms a call: {each}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
