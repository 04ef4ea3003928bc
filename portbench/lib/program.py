"""What the benchmark takes from the program under test
(google_nerf_tpu_torch): its configuration objects built from the
configuration and traffic files, and checks that the program's derived
layout (level resolutions, march group) is the one the files state."""
from __future__ import annotations

import dataclasses

import torch

TABLE_KEY = {"packed": "packed_table", "hash": "hash_table"}


def ngp_config(model: dict):
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    kw = dict(model)
    kw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    return NGPConfig(**kw)


def train_config(model: dict, recipe: dict):
    from google_nerf_tpu_torch.train.system import TrainConfig
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(model=ngp_config(model),
                       **{k: v for k, v in recipe.items() if k in names})


def program_params(spec, p):
    """The program's parameter dict over the benchmark's tensors."""
    return {TABLE_KEY[spec.encoder]: p["table"],
            "sigma_mlp": list(p["sigma_mlp"]), "rgb_mlp": list(p["rgb_mlp"])}


def leaf_map(spec):
    """benchmark leaf name -> the program's (param_leaves') name."""
    return {"table": TABLE_KEY[spec.encoder]}


def check_layout(ngp, spec, recipe=None):
    """The program's resolutions and march group must be the files'."""
    from google_nerf_tpu_torch.ops.march_block import block2_group
    enc = (ngp.packed_cfg if spec.encoder == "packed" else ngp.hash_cfg)
    if tuple(enc.resolutions) != tuple(spec.resolutions):
        raise RuntimeError(f"level resolutions: program {enc.resolutions}"
                           f", reference {spec.resolutions}")
    if recipe is not None:
        g = block2_group(recipe["max_samples"], ngp.scale, ngp.grid_size)
        if g != recipe["march_group"]:
            raise RuntimeError(f"march group: program {g}, traffic "
                               f"{recipe['march_group']}")
