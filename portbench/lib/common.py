"""Pieces both runners share: the clock, the device block of the result
line, the card's power limit, the traced slice and the breakdown."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch

from portbench.lib import harness, spans
from portbench.lib.trace import Trace, load


def t0() -> float:
    """Process start as the harness saw it (or now, when driven from a
    test)."""
    if getattr(harness, "T0", None) is None:
        harness.T0 = time.perf_counter()
    return harness.T0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def device_block(dev, count: int = 1):
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def traced(fn, dev) -> Trace:
    """Profile fn() inside the host range spans.WINDOW, ended by a
    synchronise, and reduce its Chrome trace (written to TMPDIR and
    removed)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(spans.WINDOW):
            fn()
            sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace(load(path), spans.WINDOW)
    finally:
        os.remove(path)


def breakdown(tr: Trace):
    return dict(device_ops=tr.top_ops(10), idle_gaps=tr.idle_gaps(10))


def say(*a):
    print("portbench:", *a, file=sys.stderr, flush=True)
