"""The depth network at its full architecture on the CPU: ResNeXt101-32x8d
(32 groups of width 8, 23 blocks in layer 3) with the encoder-site cIMLE
AdaIN at d_latent 32, the CLIs' default model, at 64x64 with a batch of
2.  JAX's init carried across by convert.depth_state_from_jax; the same
seeded numpy image and latents through JAX's DepthNet and the port's.

Tolerance: the logit norm-relative 1e-4 (101 f32 layers summed in
another order; seen 1.1e-6), depth_inference likewise, and its minimum
over the batch 0.01."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import DepthNet as JNet
from google_nerf_tpu.depth.model import depth_inference as jax_inference
from google_nerf_tpu.depth.model import init_depth_model as jax_init
from google_nerf_tpu_torch.convert import depth_state_from_jax
from google_nerf_tpu_torch.depth.model import (DepthModelConfig, DepthNet,
                                               depth_forward,
                                               depth_inference,
                                               normalize_rgb)

KW = dict(backbone="resnext101_32x8d", d_latent=32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_resnext101_cimle_matches_jax():
    variables = jax_init(jax.random.PRNGKey(0), JConfig(**KW), (64, 64))
    model = DepthNet(DepthModelConfig(**KW)).eval()
    model.load_state_dict(depth_state_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(np.size(v) for v in jax.tree_util.tree_leaves(
        variables["params"]))
    assert 116e6 < n_params < 117e6

    rng = np.random.default_rng(4)
    rgb01 = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
    z = rng.normal(size=(2, 32)).astype(np.float32)
    x = normalize_rgb(torch.from_numpy(rgb01))
    want = JNet(JConfig(**KW)).apply(
        variables, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
        z=jnp.asarray(z))
    got = depth_forward(model, x, torch.from_numpy(z))
    assert tuple(got.shape) == (2, 1, 64, 64)
    assert _rel(got.numpy().transpose(0, 2, 3, 1), want) <= 1e-4

    d_want = jax_inference(variables, JConfig(**KW),
                           jnp.asarray(rgb01.transpose(0, 2, 3, 1)),
                           z=jnp.asarray(z))
    d = depth_inference(model, torch.from_numpy(rgb01), torch.from_numpy(z))
    assert _rel(d.numpy().transpose(0, 2, 3, 1), d_want) <= 1e-4
    assert float(d.min()) == pytest.approx(0.01, abs=1e-6)
