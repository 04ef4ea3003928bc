"""Spawn a world of ranks in this machine and gather what each returns.

    results = run_world(fn, 2, args, backend="gloo", device="cpu")

Each rank is a process started by multiprocessing's spawn method: it
caps torch's threads, joins a new process group over loopback TCP (a
free port, rank r of world_size), runs fn(*args) and hands back fn's
result with every tensor in it as a numpy array.  The caller gets the
results in rank order.  A rank that raises, exits or outlives `timeout`
fails the world: every rank is killed and the caller gets a
RuntimeError (with the rank's traceback) or a TimeoutError.  fn must be
importable by name (a module-level function of an importable module).

This is how the tests and chip_smoke.py make worlds of two: gloo on the
CPU, or gloo with both ranks on one card (NCCL refuses two ranks on one
device).  torchrun makes the CLIs' worlds (parallel/dp.init_distributed).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(tree):
    """tree with every tensor replaced by a numpy array (bfloat16 as
    float32)."""
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _rank_main(fn, rank, world_size, port, backend, device, threads, args,
               results, timeout):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = to_numpy(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:               # reported to the caller, who fails
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size: int, args=(), *, backend: str = "gloo",
              device="cpu", timeout: float = 120.0, threads: int = 1):
    """fn(*args) on each rank of a new world of `world_size` processes on
    `device`; returns the ranks' results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, port, backend, str(device), threads, args,
        results, timeout)) for r in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"world of {world_size}: ranks {late} "
                                   f"did not finish in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a last look: the rank may have reported as it exited
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"world of {world_size}: rank {dead[0]} exited "
                            f"with code {procs[dead[0]].exitcode} and no "
                            "result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"world of {world_size}: rank {rank} "
                                   f"failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    return [got[r] for r in range(world_size)]
