"""The pair renderer `render_brick` (no kernel) in the PyTorch port against
google_nerf_tpu/models/render_brick.py on JAX's own 64^3 bake of the
fixture of tests/test_render_brick.py (grid 16, a 4-level packed table
scaled by 1e3), carried to torch bit for bit.

Frames: rgb and opacity within atol 2e-3 (PERF.md's frame tolerance);
pairs_dropped, pairs_total, pairs_per_chunk, trunc_tiles and trunc_rays
equal."""
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
from google_nerf_tpu.models.render_brick import render_brick as jax_render
from google_nerf_tpu_torch.models.baked import BakedConfig
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_brick import render_brick
from test_torch_render_brick_mxu import jax_bf16_to_torch

BASE = dict(L=64, Lk=16, max_samples=128, pairs_per_ray=16.0)
CASES = {
    "frame": (16, 16, BASE),
    "single_level_cull": (16, 16, dict(BASE, macro_tiles=0)),
    "not_tile_multiple": (13, 11, BASE),
    "chunked": (16, 16, dict(BASE, chunk_tiles=3)),
    "budget_cut": (16, 16, dict(BASE, pairs_per_ray=2.0)),
    "short_lists": (16, 16, dict(BASE, L=24, Lk=3)),
    "passes": (16, 16, dict(BASE, pass_fracs=(0.5, 0.25), drain_frac=0.3)),
}
COUNTERS = ("pairs_dropped", "pairs_total", "trunc_tiles", "trunc_rays")


@pytest.fixture(scope="module")
def scene():
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=16,
                      packed_log2_size=12, packed_levels=4)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 1e3
    occ = jnp.ones((jcfg.cascades,) + (jcfg.grid_size,) * 3, bool)
    jbcfg = jbaked.BakedConfig(voxel_res=64, block=8)
    jb = jbaked.bake(params, jcfg, occ, jbcfg)
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(16, 16))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    return dict(
        jcfg=jcfg, jbcfg=jbcfg, jb=jb, o=o, d=d,
        cfg=NGPConfig(scale=0.5, encoder="packed", grid_size=16,
                      packed_log2_size=12, packed_levels=4),
        bcfg=BakedConfig(voxel_res=64, block=8),
        tb=dict(block_map=torch.as_tensor(np.array(jb["block_map"])),
                pool=jax_bf16_to_torch(jb["pool"]),
                rgb_mlp=[torch.as_tensor(np.array(w))
                         for w in jb["rgb_mlp"]], n_blocks=jb["n_blocks"]))


def render_both(sc, W, H, kw):
    sel = (np.arange(H)[:, None] * 16 + np.arange(W)[None]).reshape(-1)
    o, d = np.array(sc["o"])[sel], np.array(sc["d"])[sel]
    want = jax_render(sc["jb"], sc["jcfg"], jnp.asarray(o), jnp.asarray(d),
                      W, H, bcfg=sc["jbcfg"], **kw)
    got = render_brick(sc["tb"], sc["cfg"], torch.as_tensor(o),
                       torch.as_tensor(d), W, H, bcfg=sc["bcfg"],
                       device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_render_brick_equals_jax(scene, case):
    W, H, kw = CASES[case]
    got, want = render_both(scene, W, H, kw)
    assert got["rgb"].shape == (W * H, 3)
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3, rtol=0, err_msg=k)
    for k in COUNTERS:
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_array_equal(got["pairs_per_chunk"].numpy(),
                                  np.asarray(want["pairs_per_chunk"]))
    assert float(got["opacity"].max()) > 0.1
    if case == "budget_cut":
        assert int(got["pairs_dropped"]) > 0
    if case == "short_lists":
        assert int(got["trunc_rays"]) > 0


def test_chunking_is_invariant(scene):
    """A multi-chunk frame (a padded partial last chunk) equals the
    one-chunk frame, as tests/test_render_brick.py holds JAX's."""
    W, H, kw = CASES["frame"]
    one = render_both(scene, W, H, dict(kw, chunk_tiles=10 ** 6))[0]
    multi = render_brick(scene["tb"], scene["cfg"],
                         torch.as_tensor(np.array(scene["o"])),
                         torch.as_tensor(np.array(scene["d"])), W, H,
                         bcfg=scene["bcfg"], device="cpu",
                         **dict(kw, chunk_tiles=3))
    np.testing.assert_allclose(multi["rgb"].numpy(), one["rgb"].numpy(),
                               atol=1e-4, rtol=0)
    assert int(one["pairs_dropped"]) == 0
