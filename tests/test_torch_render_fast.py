"""The fast bucket-compaction test renderer of the PyTorch port against
JAX's render_test_fast (the fixture of tests/test_render_fast.py: grid
16, 2 packed levels of 2^8 rows scaled by 1e4, 30% occupancy, a 24x24
view), and render_test_baked against JAX's on JAX's bake (the case of
tests/test_baked.py: grid 16, 4 levels of 2^12 rows x1e3, a 32^3 bake of
4^3 bricks, a 16x16 view).

Tolerances: rgb, opacity and depth atol 2e-3 (PERF.md's frame
tolerance: the same samples, summed in another order); the all-dead
frame is exactly the white background."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core.rays import get_rays
from google_nerf_tpu.data.synthetic import SyntheticDataset
from google_nerf_tpu.models import baked as jbaked
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp
from google_nerf_tpu.models.render_test_fast import \
    render_test_fast as jax_fast
from google_nerf_tpu.ops.grid import pack_occupancy_u8
from google_nerf_tpu.ops.march_seg import required_dilation_radius
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models import baked as tbaked
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_test_fast import render_test_fast
from test_torch_render_brick_mxu import jax_bf16_to_torch

FAST = dict(bucket=128, k=16, seg=8, n_segs=8, max_samples=256)


def _t(a):
    return torch.as_tensor(np.array(a))


def _frames_close(got, want):
    for k in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3, err_msg=k)


@pytest.fixture(scope="module")
def scene():
    kw = dict(scale=0.5, encoder="packed", packed_levels=2,
              packed_log2_size=8, grid_size=16)
    jcfg = JNGPConfig(compute_dtype=jnp.float32, **kw)
    key = jax.random.PRNGKey(0)
    params = init_ngp(key, jcfg)
    params["packed_table"] = params["packed_table"] * 1e4
    occ = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.3,
                               (1, 16, 16, 16))
    occ_u8 = pack_occupancy_u8(occ, required_dilation_radius(8, 16, 256,
                                                             0.5))
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(24, 24))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    return dict(jcfg=jcfg, cfg=NGPConfig(compute_dtype=torch.float32, **kw),
                params=params, occ_u8=occ_u8, o=o, d=d,
                tparams=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), "cpu"))


@pytest.mark.parametrize("chunk,n_keep", [(576, 8), (576, 4), (200, 8)])
def test_fast_matches_jax(scene, chunk, n_keep):
    """One chunk (n_keep 8 as the JAX test; 4 makes windows overflow and
    resume at the first dropped live segment) and three padded chunks."""
    s = scene
    kw = dict(FAST, T_threshold=1e-4, chunk=chunk, n_keep=n_keep)
    want = jax_fast(s["params"], s["jcfg"], s["occ_u8"], s["o"], s["d"],
                    **kw)
    got = render_test_fast(s["tparams"], s["cfg"], _t(s["occ_u8"]),
                           _t(s["o"]), _t(s["d"]), **kw)
    assert float(np.asarray(want["opacity"]).mean()) > 0.05
    _frames_close(got, want)


def test_fast_handles_all_dead_rays(scene):
    """Rays that miss the box: white background, zero opacity, as JAX."""
    s = scene
    kw = dict(FAST, chunk=576, n_keep=4)
    want = jax_fast(s["params"], s["jcfg"], s["occ_u8"], s["o"] + 5.0,
                    s["d"], **kw)
    got = render_test_fast(s["tparams"], s["cfg"], _t(s["occ_u8"]),
                           _t(s["o"]) + 5.0, _t(s["d"]), **kw)
    np.testing.assert_array_equal(got["rgb"].numpy(), 1.0)
    np.testing.assert_array_equal(got["opacity"].numpy(), 0.0)
    _frames_close(got, want)


def test_render_test_baked_matches_jax():
    kw = dict(scale=0.5, encoder="packed", grid_size=16, packed_log2_size=12,
              packed_levels=4)
    jcfg = JNGPConfig(**kw)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 1e3
    occ = jnp.ones((1, 16, 16, 16), bool)
    jb = jbaked.bake(params, jcfg, occ, jbaked.BakedConfig(voxel_res=32,
                                                           block=4))
    tb = dict(block_map=_t(jb["block_map"]),
              pool=jax_bf16_to_torch(jb["pool"]),
              rgb_mlp=[_t(w) for w in jb["rgb_mlp"]], n_blocks=jb["n_blocks"])
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(16, 16))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    occ_u8 = pack_occupancy_u8(occ, 2, super_radius=5)
    fkw = dict(k=8, seg=8, n_segs=8, n_keep=4, max_samples=64, bucket=64,
               chunk=256)
    want = jbaked.render_test_baked(jb, jcfg, occ_u8, o, d,
                                    bcfg=jbaked.BakedConfig(voxel_res=32,
                                                            block=4), **fkw)
    got = tbaked.render_test_baked(tb, NGPConfig(**kw), _t(occ_u8), _t(o),
                                   _t(d), bcfg=tbaked.BakedConfig(
                                       voxel_res=32, block=4), **fkw)
    assert float(np.asarray(want["opacity"]).mean()) > 0.05
    _frames_close(got, want)
