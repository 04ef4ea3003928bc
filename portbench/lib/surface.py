"""A served field whose rays end at the scene's surface, made from the
seed and the benchmark's analytic scene, as a trained field's are.

The hash field's weights start from the seed (reference.field.
make_params: the table U[-1e-4, 1e-4], the MLPs Kaiming-uniform), then
three things are written over them:

  * feature 1 of level 0 is 1 at every row, an input that is constant
    everywhere (the MLPs have no bias);
  * feature 0 of the surface level (the finest level whose vertices the
    table holds without hashing) is the scene's solid at its vertices:
    1 where the analytic sigma exceeds 1, else 0.  Interpolated, it is
    the solid blurred to that level's cells;
  * the density logit is gain * f - bias of that feature f, through two
    hidden units, so sigma * dt is 1 where f is `iso` and grows by
    e^gain over the unit of f: the field turns opaque within about a
    sample of its surface.  The other geometry features and the colour
    come from the seed's weights; the density logit does not feed the
    colour.
"""
from __future__ import annotations

import math

import torch

from portbench.lib import scene
from portbench.reference import field as rf


def surface_level(spec) -> int:
    """The finest level whose (res + 1)^3 vertices the table holds
    one to a row; level 0 (hashed) where none does."""
    dense = [lv for lv, r in enumerate(spec.resolutions)
             if (r + 1) ** 3 <= spec.table_rows]
    return dense[-1] if dense else 0


@torch.no_grad()
def surface_params(spec, seed: int, device, *, gain: float, iso: float,
                   max_samples: int):
    """The field's parameters (reference.field.make_params' layout)."""
    if spec.encoder != "hash" or spec.n_features < 2:
        raise ValueError("the surface field is written for the hash "
                         "encoder with two features or more")
    p = rf.make_params(spec, seed, device)
    table, T, F = p["table"], spec.table_rows, spec.n_features
    table[0, :, 1] = 1.0
    lv = surface_level(spec)
    r = spec.resolutions[lv]
    c = torch.arange(r + 1, device=device)
    v = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    world = (v.to(torch.float32) / r * 2 - 1) * spec.scale
    sigma, _ = scene.analytic_field(world)
    solid = (sigma > 1.0).to(torch.float32)
    if (r + 1) ** 3 <= T:
        row = v[:, 0] + v[:, 1] * (r + 1) + v[:, 2] * (r + 1) ** 2
    else:
        row = rf._hash(v, T)
    table[lv, :, 0] = torch.zeros(T, device=device).scatter_reduce(
        0, row, solid, "amax")
    dt = math.sqrt(3.0) / max_samples
    bias = gain * iso - math.log(1.0 / dt)
    w0, w1 = p["sigma_mlp"]
    w0[:, :2] = 0.0
    w0[lv * F, 0] = gain            # hidden 0: gain * f
    w0[1, 1] = 1.0                  # hidden 1: the constant 1
    w1[:2, :] = 0.0
    w1[0, 0] = 1.0
    w1[1, 0] = -bias
    w1[2:, 0] = 0.0                 # the logit reads hidden 0 and 1 alone
    p["rgb_mlp"][0][16] = 0.0       # and does not feed the colour
    return p
