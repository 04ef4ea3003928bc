"""Multi-scene training: one scene a rank (port of
google_nerf_tpu/parallel/multiscene.py).

JAX trains S scenes at once over a Mesh(('scene',)), each group running
the fused train step on its own slice of stacked params, grids and
optimizer states.  Here a world of S ranks holds one scene each: every
rank steps its own state on its own scene and draws, and only the
metrics (and, to save them, the states) cross ranks.  `gather_states`
and `scatter_states` stand for JAX's stack_states and unstack_states:
the per-scene states gathered onto every rank, so that rank 0 can save
them, and rank 0's list handed out one a rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from google_nerf_tpu_torch.parallel import comm
from google_nerf_tpu_torch.train.system import (TrainConfig,
                                                fused_train_step)


def make_multiscene_train_step(cfg: TrainConfig, group=None):
    """Returns step(state, scene, *, draws=None, generator=None) ->
    (state, metrics): this rank's scene stepped once (fused_train_step on
    its own draws), the metrics gathered onto every rank as (S,) tensors
    in rank (scene) order."""
    def step(state, scene, *, draws=None, generator=None):
        state, m = fused_train_step(state, scene, cfg, draws=draws,
                                    generator=generator)
        keys = list(m)
        dev = m["loss"].device
        vals = torch.stack([torch.as_tensor(m[k], dtype=torch.float32,
                                            device=dev).reshape(())
                            for k in keys])
        per_scene = comm.all_gather_cat(vals[None], group)
        return state, {k: per_scene[:, i] for i, k in enumerate(keys)}

    return step


def gather_states(state, group=None):
    """Every rank's state as numpy leaves (convert.train_state_to_numpy's
    layout) in rank order, on every rank."""
    from google_nerf_tpu_torch.convert import train_state_to_numpy
    return comm.all_gather_objects(train_state_to_numpy(state), group)


def scatter_states(trees, cfg: TrainConfig, group=None, src: int = 0,
                   device="cuda"):
    """Rank src's list of S per-scene numpy states (gather_states' or
    convert.multiscene_states_from_jax's layout) handed out one a rank:
    returns this rank's as a train state on `device`."""
    from google_nerf_tpu_torch.convert import train_state_from_jax
    if comm.get_world_size(group) == 1:
        return train_state_from_jax(trees[0], cfg, device)
    out = [None]
    dist.scatter_object_list(out, trees if comm.get_rank(group) == src
                             else None, src=src, group=group)
    return train_state_from_jax(out[0], cfg, device)
