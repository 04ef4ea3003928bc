"""Few-step debug trainer of the PyTorch port (the port's
train_debug.py): loads the dataset, prints its shapes, the config and
every leaf of the train state, then runs --steps steps printing each
step's metrics and the occupancy after each grid update, and ends with
the encoder table's statistics.

    python train_debug_torch.py --dataset_name synthetic --root_dir x \\
        --steps 3

Runs on the CUDA card unless given --platform cpu.
"""
from __future__ import annotations

import argparse
import time

import torch

from google_nerf_tpu_torch.opt import get_opts
from train_torch import build_configs, device_of, make_dataset


def main(hparams, steps: int = 3):
    from google_nerf_tpu_torch.train.system import (fused_train_step,
                                                    grid_update_step,
                                                    init_train_state,
                                                    param_leaves)
    dev = device_of(hparams)
    ds = make_dataset(hparams, hparams.split, dev)
    cfg = build_configs(hparams)
    print(f"dataset: {len(ds.poses)} poses, img_wh={ds.img_wh}, "
          f"rays={getattr(ds.rays, 'shape', None)}")
    print(f"config: {cfg}")

    state = init_train_state(
        cfg, ds.K, ds.poses, ds.img_wh,
        generator=torch.Generator().manual_seed(hparams.seed), device=dev)
    print("state leaves:")
    leaves = {f"params/{k}": v
              for k, v in param_leaves(state["params"]).items()}
    for k in ("density_grid", "occ", "occ_u8"):
        v = state[k]
        leaves.update({f"{k}/{n}": t for n, t in v.items()}
                      if isinstance(v, dict) else {k: v})
    for name, leaf in leaves.items():
        print(f"  {name}: {tuple(leaf.shape)} {leaf.dtype}")
    print(f"  step: {state['step']}")

    scene = ds.scene()
    gen = torch.Generator(device=dev).manual_seed(hparams.seed)
    metrics = {}
    for i in range(steps):
        t0 = time.time()
        if i % cfg.grid_update_interval == 0:
            grid_update_step(state, cfg, warmup=i < cfg.warmup_steps,
                             generator=gen)
            occ = float(state["occ"].float().mean())
            print(f"[step {i}] grid update: occ_frac={occ:.4f}")
        state, metrics = fused_train_step(state, scene, cfg, generator=gen)
        print(f"[step {i}] " + " ".join(
            f"{k}={float(v):.5g}" for k, v in metrics.items())
            + f" ({time.time() - t0:.2f}s)")
    params = state["params"]
    tbl = next((params[k] for k in ("packed_table", "hash_table")
                if k in params), None)
    if tbl is not None:
        t = tbl.detach().abs()
        print(f"table stats: mean|w|={float(t.mean()):.3e} "
              f"max|w|={float(t.max()):.3e}")
    print("debug run complete")
    return state, metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--steps", type=int, default=3)
    known, rest = parser.parse_known_args()
    main(get_opts(rest), steps=known.steps)
