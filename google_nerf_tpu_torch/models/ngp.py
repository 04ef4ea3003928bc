"""The NGP radiance field (port of google_nerf_tpu/models/ngp.py).

Params are a dict with the JAX pytree's keys: the encoder's table
(`hash_table` (L, T, F), `packed_table` (L, T, 8F) or `pair_table`
(P, T, 35F), f32; none for the frequency encoder), `sigma_mlp` and
`rgb_mlp` (lists of (din, dout) f32 weights).  xyz encoders: "hash"
(the reference's Instant-NGP grid), "freq" (12 bands, the fork's
config), "packed" (packed-corner rows) and "packed2" (paired-level
rows).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from google_nerf_tpu_torch.core.rays import norm3
from google_nerf_tpu_torch.models.encoders import (HashGridConfig,
                                                   frequency_encode,
                                                   hash_encode,
                                                   hashgrid_config_for_scale,
                                                   init_hashgrid,
                                                   sh_encode_deg4)
from google_nerf_tpu_torch.models.mlp import init_mlp, mlp_apply
from google_nerf_tpu_torch.ops.packed_hash import (PackedHashConfig,
                                                   init_packed_hash,
                                                   packed_config_for_scale,
                                                   packed_hash_encode)
from google_nerf_tpu_torch.ops.packed_pair import (
    PackedPairConfig, init_packed_pair, packed_pair_config_for_scale,
    packed_pair_encode)
from google_nerf_tpu_torch.ops.trunc_exp import trunc_exp
from google_nerf_tpu_torch.utils.logging import count, span


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    scale: float = 0.5
    encoder: str = "hash"            # "hash" | "freq" | "packed" | "packed2"
    num_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    n_freqs: int = 12
    packed_levels: int = 8
    packed_features: int = 2
    packed_log2_size: int = 16
    packed_max_res: int = 0          # 0 = reference N_max (2048*scale)
    packed_table_dtype: str = "bfloat16"
    grid_size: int = 128
    sigma_width: int = 64
    geo_feat_dim: int = 16
    rgb_width: int = 64
    rgb_layers: int = 2
    compute_dtype: Any = torch.float32

    @property
    def cascades(self) -> int:
        return max(1 + int(np.ceil(np.log2(2 * self.scale))), 1)

    @property
    def hash_cfg(self) -> HashGridConfig:
        return hashgrid_config_for_scale(
            self.scale, num_levels=self.num_levels,
            n_features=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution)

    @property
    def packed_cfg(self) -> PackedHashConfig:
        return packed_config_for_scale(
            self.scale, n_levels=self.packed_levels,
            n_features=self.packed_features,
            log2_table_size=self.packed_log2_size,
            max_resolution=self.packed_max_res,
            table_dtype=self.packed_table_dtype)

    @property
    def pair_cfg(self) -> PackedPairConfig:
        # packed_levels effective levels = packed_levels // 2 pair tables
        return packed_pair_config_for_scale(
            self.scale, n_pairs=max(self.packed_levels // 2, 1),
            n_features=self.packed_features,
            log2_table_size=self.packed_log2_size,
            max_resolution=self.packed_max_res,
            table_dtype=self.packed_table_dtype)

    @property
    def xyz_feat_dim(self) -> int:
        if self.encoder == "hash":
            return self.hash_cfg.out_dim
        if self.encoder == "packed":
            return self.packed_cfg.out_dim
        if self.encoder == "packed2":
            return self.pair_cfg.out_dim
        return 3 * 2 * self.n_freqs


def init_ngp(generator: torch.Generator, cfg: NGPConfig,
             device="cuda") -> Dict[str, Any]:
    """Random params from `generator` (a CPU torch.Generator); the
    numbers differ from jax.random's, so parity tests carry JAX params
    across with convert.params_from_jax instead."""
    params: Dict[str, Any] = {}
    if cfg.encoder == "hash":
        params["hash_table"] = init_hashgrid(generator, cfg.hash_cfg, device)
    elif cfg.encoder == "packed":
        params["packed_table"] = init_packed_hash(generator, cfg.packed_cfg,
                                                  device)
    elif cfg.encoder == "packed2":
        params["pair_table"] = init_packed_pair(generator, cfg.pair_cfg,
                                                device)
    elif cfg.encoder != "freq":
        raise ValueError(f"unknown encoder {cfg.encoder!r}")
    params["sigma_mlp"] = init_mlp(
        generator, [cfg.xyz_feat_dim, cfg.sigma_width, cfg.geo_feat_dim],
        device)
    params["rgb_mlp"] = init_mlp(
        generator, [16 + cfg.geo_feat_dim]
        + [cfg.rgb_width] * cfg.rgb_layers + [3], device)
    return params


def _encode_xyz(params, cfg: NGPConfig, x01):
    if cfg.encoder == "hash":
        return hash_encode(params["hash_table"], x01, cfg.hash_cfg)
    if cfg.encoder == "packed":
        return packed_hash_encode(params["packed_table"], x01,
                                  cfg.packed_cfg)
    if cfg.encoder == "packed2":
        return packed_pair_encode(params["pair_table"], x01, cfg.pair_cfg)
    return frequency_encode(x01, cfg.n_freqs)


def ngp_density(params, cfg: NGPConfig, x, return_feat: bool = False):
    """x: (N, 3) world coords in [-scale, scale] -> sigmas (N,)
    (+ geometric features (N, geo_feat_dim) if return_feat)."""
    count("field_points", x.numel() // 3)
    x01 = (x + cfg.scale) / (2 * cfg.scale)
    with span("ngp.encoder"):
        enc = _encode_xyz(params, cfg, x01)
    with span("ngp.mlp"):
        h = mlp_apply(params["sigma_mlp"], enc,
                      compute_dtype=cfg.compute_dtype)
        sigmas = trunc_exp(h[..., 0])
    if return_feat:
        return sigmas, h
    return sigmas


def ngp_apply(params, cfg: NGPConfig, x, d):
    """x, d: (N, 3) positions and view directions -> sigmas (N,),
    rgbs (N, 3)."""
    sigmas, h = ngp_density(params, cfg, x, return_feat=True)
    with span("ngp.mlp"):
        d = d / norm3(d, keepdim=True)
        rgb_in = torch.cat([sh_encode_deg4(d), h], dim=-1)
        logits = mlp_apply(params["rgb_mlp"], rgb_in,
                           compute_dtype=cfg.compute_dtype)
        rgbs = torch.sigmoid(logits)
    return sigmas, rgbs
