"""The multi-device dry run and the weak-scaling report (the port's
counterparts of __graft_entry__.dryrun_multichip and
weak_scaling_report).

    python -m google_nerf_tpu_torch.parallel.dryrun [--n 2]
        [--device cpu|cuda] [--backend gloo|nccl]

dryrun_multichip(n) spawns a world of n ranks (launch.run_world) and
checks the data-parallel structure on tiny shapes: one DP step, then
step == 1; the sharded grid update against the serial one on the same
draws, bit for bit (JAX allows 1e-4 and < 1% occupancy flips for XLA's
fusion; here both run the same chunks in the same order); the DP
one-shot frame against the serial frame at atol 1e-5.  Then
weak_scaling_report times a step at a fixed count of rays a rank in a
world of 1 and of n, with and without the gradient all-reduce, and the
sharded grid update.  Its bounds (the all-reduce's share of the step
< 1, the step's growth from 1 to n ranks < 4) are bounds for ranks that
share a host's cores; for ranks that share one card
(`assert_scaling=False`) they are printed, not asserted.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from google_nerf_tpu_torch.parallel.launch import run_world

SEEDS = dict(init=0, warmup=1, step=2, grid=3, scaling=7)


def _config(batch_size: int):
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    from google_nerf_tpu_torch.train.system import TrainConfig
    model = NGPConfig(scale=0.5, encoder="packed", packed_levels=4,
                      packed_log2_size=10, grid_size=32)
    return TrainConfig(model=model, batch_size=batch_size, k_samples=16,
                       max_samples=64, random_bg=True,
                       exclude_incomplete="backfill")


def _world_state(cfg, device):
    """The synthetic scene (4 views at 24^2) and a replicated state after
    a warmup grid update."""
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.parallel.dp import replicate
    from google_nerf_tpu_torch.train.system import (grid_update_step,
                                                    init_train_state)
    ds = SyntheticDataset(split="train", n_images=4, img_wh=(24, 24),
                          device=str(device))
    state = init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                             generator=torch.Generator().manual_seed(
                                 SEEDS["init"]), device=device)
    replicate(state)
    grid_update_step(state, cfg, warmup=True, generator=torch.Generator(
        device=device).manual_seed(SEEDS["warmup"]))
    return ds.scene(), state


def _dryrun_rank(device):
    """One rank of dryrun_multichip: returns its checks' numbers."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    from google_nerf_tpu_torch.parallel import comm
    from google_nerf_tpu_torch.parallel.dp import (make_dp_grid_update,
                                                   make_dp_train_step,
                                                   render_test_oneshot_dp)
    from google_nerf_tpu_torch.ops.grid import grid_draws
    from google_nerf_tpu_torch.train.system import grid_update_step
    device = torch.device(device)
    n, rank = comm.get_world_size(), comm.get_rank()
    cfg = _config(128 * n)
    scene, state = _world_state(cfg, device)
    step = make_dp_train_step(cfg)
    state, metrics = step(state, scene, generator=torch.Generator(
        device=device).manual_seed(SEEDS["step"] + rank))
    out = dict(step=state["step"], loss=float(metrics["loss"]))

    # the sharded grid update against the serial one on the same draws
    m = cfg.model
    draws = grid_draws(m.grid_size, m.cascades, warmup=False,
                       sample_div=cfg.grid_sample_div,
                       generator=torch.Generator(device=device).manual_seed(
                           SEEDS["grid"]), device=device)
    serial = grid_update_step(dict(state), cfg, warmup=False, draws=draws)
    make_dp_grid_update(cfg)(state, warmup=False, draws=draws)
    out["grid_equal"] = bool(torch.equal(state["density_grid"],
                                         serial["density_grid"]))
    out["occ_equal"] = bool(torch.equal(state["occ"], serial["occ"]))
    out["grid_max_diff"] = float((state["density_grid"]
                                  - serial["density_grid"]).abs().max())
    out["occ_cells"] = int(state["occ"].sum())

    # the DP one-shot frame against the serial frame on the same state
    ds_t = SyntheticDataset(split="test", n_images=1, img_wh=(24, 16),
                            device=str(device))
    o, d = get_rays(torch.as_tensor(ds_t.directions, device=device),
                    torch.as_tensor(ds_t.poses[0], device=device))
    kw = dict(max_samples=64, k=16, n_keep=8, sup=4, n_keep_sup=8,
              chunk=128, straggler_div=8, budget_div=0, drain=True,
              T_threshold=1e-2)
    from google_nerf_tpu_torch.train.system import pack_marching_grid
    words = pack_marching_grid(state["occ"], cfg)
    ref = render_test_oneshot(state["params"], m, words, o, d, **kw)
    got = render_test_oneshot_dp(state["params"], m, words, o, d, **kw)
    out["render_max_diff"] = max(float((got[k] - ref[k]).abs().max())
                                 for k in ("rgb", "opacity", "depth"))
    out["render_mae"] = float((got["rgb"] - ref["rgb"]).abs().mean())
    out["table"] = state["params"]["packed_table"]
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _scaling_rank(per_rank_rays: int, n_timed: int, device):
    """One rank of weak_scaling_report: ms a DP step (with and, in a
    world of more than one, without the all-reduce) and ms a sharded grid
    update."""
    from google_nerf_tpu_torch.parallel import comm
    from google_nerf_tpu_torch.parallel.dp import (make_dp_grid_update,
                                                   make_dp_train_step)
    device = torch.device(device)
    n, rank = comm.get_world_size(), comm.get_rank()
    cfg = _config(per_rank_rays * n)
    scene, state = _world_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEEDS["scaling"] + rank)
    grid_gen = torch.Generator(device=device).manual_seed(SEEDS["scaling"])

    def timed(fn):
        fn()                                    # first call apart
        _sync(device)
        comm.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            fn()
        _sync(device)
        return 1e3 * (time.perf_counter() - t0) / n_timed

    out = {}
    for name, coll in (("step_ms", True), ("step_nocoll_ms", False)):
        if coll or n > 1:
            st = make_dp_train_step(cfg, collectives=coll)
            out[name] = timed(lambda: st(state, scene, generator=gen))
            out["allreduce_bytes"] = st.allreduce_bytes
    gup = make_dp_grid_update(cfg)
    out["grid_ms"] = timed(lambda: gup(state, warmup=False,
                                       generator=grid_gen))
    return out


def weak_scaling_report(n: int, per_rank_rays: int = 128, n_timed: int = 6,
                        *, backend: str = "gloo", device="cpu",
                        timeout: float = 300.0):
    """ms a DP step and a sharded grid update at a fixed count of rays a
    rank, in worlds of 1 and n: {k: {"step_ms", "grid_ms", and for k > 1
    "step_nocoll_ms"}} (rank 0's numbers), one printed line a world."""
    out = {}
    for k in sorted({1, n}):
        out[k] = run_world(_scaling_rank, k, (per_rank_rays, n_timed,
                                              str(device)),
                           backend=backend, device=device,
                           timeout=timeout)[0]
        print(f"weak_scaling ranks={k} rays_per_rank={per_rank_rays}: "
              f"step {out[k]['step_ms']:.1f} ms (all-reduced grads and "
              "loss" + (f"; without the all-reduce "
                        f"{out[k]['step_nocoll_ms']:.1f} ms"
                        if "step_nocoll_ms" in out[k] else "")
              + f"), grid update {out[k]['grid_ms']:.1f} ms (MAX merge)",
              flush=True)
    return out


def dryrun_multichip(n: int = 2, *, backend: str = "gloo", device="cpu",
                     assert_scaling: bool = True, timeout: float = 300.0,
                     per_rank_rays: int = 128, n_timed: int = 6):
    """The structure checks in a world of n, then the weak-scaling
    report; raises AssertionError on a failed check.  Returns (rank 0's
    check numbers, the scaling report)."""
    ranks = run_world(_dryrun_rank, n, (str(device),), backend=backend,
                      device=device, timeout=timeout)
    r0 = ranks[0]
    assert all(r["step"] == 1 for r in ranks), "the DP step did not count 1"
    assert all(math.isfinite(r["loss"]) for r in ranks), "a non-finite loss"
    for r in ranks[1:]:
        assert np.array_equal(r["table"], r0["table"]), \
            "the ranks' params differ after one DP step"
    for r in ranks:
        assert r["grid_equal"] and r["occ_equal"], (
            f"sharded grid update != serial update (max diff "
            f"{r['grid_max_diff']:.3e})")
        assert r["render_max_diff"] <= 1e-5, (
            f"DP one-shot frame vs serial: max diff {r['render_max_diff']}")
    print(f"dryrun_multichip({n}) ok: loss={r0['loss']:.4f} "
          f"grid_sharded_vs_serial_max={r0['grid_max_diff']:.2e} "
          f"occupied={r0['occ_cells']} "
          f"dp_render_mae={r0['render_mae']:.2e}", flush=True)

    times = weak_scaling_report(n, per_rank_rays, n_timed, backend=backend,
                                device=device, timeout=timeout)
    tn = times[n]
    coll_ms = tn["step_ms"] - tn.get("step_nocoll_ms", tn["step_ms"])
    coll_frac = coll_ms / max(tn.get("step_nocoll_ms", tn["step_ms"]), 1e-9)
    ratio = tn["step_ms"] / max(times[1]["step_ms"], 1e-9)
    print("weak_scaling summary: " + " | ".join(
        f"ranks={k}: step {v['step_ms']:.1f} ms"
        + (f" (compute {v['step_nocoll_ms']:.1f} + all-reduce "
           f"{v['step_ms'] - v['step_nocoll_ms']:.1f})"
           if "step_nocoll_ms" in v else "")
        + f", grid {v['grid_ms']:.1f} ms" for k, v in sorted(times.items()))
        + f" | all-reduce {coll_frac:.2f}x of compute | step {ratio:.2f}x "
        f"from 1 -> {n} ranks" + ("" if assert_scaling else
                                  " (printed, not asserted)"), flush=True)
    if assert_scaling and n > 1:
        assert coll_frac < 1.0, (
            f"the gradient all-reduce costs {coll_ms:.1f} ms on top of "
            f"{tn['step_nocoll_ms']:.1f} ms of compute at {n} ranks "
            f"({coll_frac:.2f}x): the DP step is communication-bound")
        assert ratio < 4.0, (
            f"the step grew {ratio:.1f}x from 1 to {n} ranks at a fixed "
            "count of rays a rank")
    r0.pop("table")
    return r0, times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    dryrun_multichip(args.n, backend=args.backend, device=args.device,
                     assert_scaling=args.device == "cpu")


if __name__ == "__main__":
    main()
