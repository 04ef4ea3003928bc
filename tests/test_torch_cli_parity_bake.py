"""Slice parity of the CLIs over a bake (see
tests/test_torch_cli_parity.py): JAX's test.py and the port's
test_torch.py serve one JAX-trained state with the pair renderer
(`--renderer brick --bake_res 64`, its auto budget) and with the fast
renderer over the bake (`--renderer fast --bake --bake_res 64`); each
mean PSNR within 0.05 dB of JAX's.

Also the brick renderer at bench.py's settings (bench.py:376-379: L 256,
Lk 24, 17.6 pairs a ray, chunk_tiles 1024, max_samples 512), on JAX's
128^3 bake of the same trained state carried into the port, over a
32x32 test view: trunc_tiles, trunc_rays, pairs_dropped and pairs_total
equal to JAX's, rgb and opacity within 2e-3 (PERF.md's frame
tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core.rays import get_rays
from google_nerf_tpu.data.synthetic import SyntheticDataset
from google_nerf_tpu.models import baked as jbaked
from google_nerf_tpu.models.render_brick import render_brick as jax_brick
from google_nerf_tpu.utils.ckpt import load_ckpt
from google_nerf_tpu_torch.models.baked import BakedConfig
from google_nerf_tpu_torch.models.render_brick import render_brick
from google_nerf_tpu_torch.opt import get_opts
from test_torch_cli_parity import (TINY, carried_world,  # noqa: F401
                                   one_torch_thread, serve_both)
from test_torch_render_brick_mxu import jax_bf16_to_torch
from opt import get_opts as jax_get_opts
from train import build_configs as jax_build_configs
from train_torch import build_configs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return carried_world(tmp_path_factory)


@pytest.mark.parametrize("renderer", [
    ["--renderer", "brick", "--bake_res", "64"],
    ["--renderer", "fast", "--bake", "--bake_res", "64"]],
    ids=["brick", "fast_bake"])
def test_cli_psnr_over_a_bake_matches_jax(world, monkeypatch, renderer):
    got, want = serve_both(world, monkeypatch, renderer)
    assert np.isfinite(want)
    assert abs(got - want) <= 0.05, (got, want)


def test_brick_at_bench_settings_matches_jax(world, monkeypatch):
    """ROADMAP F2: the pair renderer's truncation counters at bench.py's
    settings against JAX's, on one trained state."""
    root, jpath, _ = world
    monkeypatch.setenv("GNT_GT_CACHE", str(root / "gt_jax"))
    jcfg = jax_build_configs(jax_get_opts(TINY)).model
    tree = jax.tree_util.tree_map(np.asarray, load_ckpt(jpath))
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    jbcfg = jbaked.BakedConfig(voxel_res=128, block=8)
    jb = jbaked.bake(params, jcfg, jnp.asarray(tree["occ"]), jbcfg)
    tb = dict(block_map=torch.tensor(np.asarray(jb["block_map"])),
              pool=jax_bf16_to_torch(jb["pool"]),
              rgb_mlp=[torch.tensor(np.asarray(w)) for w in jb["rgb_mlp"]],
              n_blocks=jb["n_blocks"])
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(32, 32),
                          style="solid")
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    kw = dict(T_threshold=1e-2, L=256, Lk=24, pairs_per_ray=17.6,
              chunk_tiles=1024, max_samples=512)
    want = jax_brick(jb, jcfg, o, d, 32, 32, bcfg=jbcfg, **kw)
    cfg = build_configs(get_opts(TINY)).model
    got = render_brick(tb, cfg, torch.tensor(np.asarray(o)),
                       torch.tensor(np.asarray(d)), 32, 32,
                       bcfg=BakedConfig(voxel_res=128, block=8),
                       device="cpu", **kw)
    print({k: int(want[k]) for k in ("trunc_tiles", "trunc_rays",
                                     "pairs_dropped", "pairs_total")})
    for k in ("trunc_tiles", "trunc_rays", "pairs_dropped", "pairs_total"):
        assert int(got[k]) == int(want[k]), k
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3, err_msg=k)
