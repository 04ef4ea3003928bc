"""Carry NGP weights from the JAX package into the port.

Both functions take numpy data only, so nothing here imports JAX: a JAX
pytree is passed as nested dicts/lists of numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)`), and the bench state is
the npz file that bench.py writes.
"""
from __future__ import annotations

import numpy as np
import torch

from google_nerf_tpu_torch.models.ngp import NGPConfig


def _t(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def params_from_jax(tree, device="cuda"):
    """init_ngp / init_train_state params (numpy leaves) -> port params.

    Keys are kept: packed_table (L, T, 8F), sigma_mlp and rgb_mlp (lists
    of (din, dout) weights), and the optional pose refinement dR/dT."""
    if "packed_table" not in tree:
        raise NotImplementedError(
            "only the packed encoder is ported (ROADMAP item 17 brings the "
            f"other tables); got keys {sorted(tree)}")
    return {k: ([_t(w, device) for w in v] if isinstance(v, (list, tuple))
                else _t(v, device)) for k, v in tree.items()}


def load_bench_state(path, cfg: NGPConfig = NGPConfig(encoder="packed"),
                     device="cuda"):
    """Read the bench.py state npz -> (params, occ).

    The file holds `occ` and the params' leaves `p0..pN` in
    jax.tree_util leaf order, i.e. dict keys sorted by name and list
    items in order:
        [dR, dT,]  packed_table,  rgb_mlp[0..rgb_layers],  sigma_mlp[0..1]
    (dR/dT exist only when the run refined poses).  `cfg` gives the
    number of rgb layers."""
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("p")
                 and k[1:].isdigit()])
        leaves = [z[f"p{i}"] for i in range(n)]
        occ = torch.as_tensor(z["occ"], device=device)
    n_rgb = cfg.rgb_layers + 1
    extra = n - (1 + n_rgb + 2)
    if extra not in (0, 2):
        raise ValueError(f"{path}: {n} param leaves do not fit the packed "
                         f"NGP layout with {n_rgb} rgb layers")
    tree = {}
    if extra:
        tree["dR"], tree["dT"] = leaves[0], leaves[1]
    rest = leaves[extra:]
    tree["packed_table"] = rest[0]
    tree["rgb_mlp"] = rest[1:1 + n_rgb]
    tree["sigma_mlp"] = rest[1 + n_rgb:]
    return params_from_jax(tree, device), occ
