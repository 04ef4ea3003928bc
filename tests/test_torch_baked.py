"""The port's bake against JAX's from the same params and occupancy, and
the .npz artifact crossing between the two packages in both directions.
block_map must be equal; the bf16 pool agrees to one bf16 rounding step
(rtol 8e-3), since the f32 field values it rounds differ in the last
bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.models import baked as jb
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp as jax_init_ngp
from google_nerf_tpu.models.render_brick_mxu import \
    render_brick_mxu as jax_render
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models import baked as tb
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_brick_mxu import render_brick_mxu
from test_torch_render_brick_mxu import jax_bf16_to_torch, make_scene

FRAME_KW = dict(max_samples=64, T_threshold=1e-2, L=64, exact_cull=16,
                pbatch=2, drain_tiles=4, drain_L=64, drain_xc=32,
                segment_slots=8, macro_tiles=0)


def _setup(block):
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=16,
                      packed_log2_size=12, packed_levels=4)
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=16,
                    packed_log2_size=12, packed_levels=4)
    jp = jax_init_ngp(jax.random.PRNGKey(0), jcfg)
    jp["packed_table"] = jp["packed_table"] * 1e3
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    occ = np.zeros((1, 16, 16, 16), bool)        # sparse, off-center content
    occ[0, 2:7, 3:9, 1:5] = np.random.RandomState(0).uniform(
        size=(5, 6, 4)) > 0.5
    return jcfg, cfg, jp, p, occ, jb.BakedConfig(voxel_res=32, block=block), \
        tb.BakedConfig(voxel_res=32, block=block)


@pytest.mark.parametrize("block", [8, 4])
def test_bake_matches_jax(block):
    jcfg, cfg, jp, p, occ, jbcfg, bcfg = _setup(block)
    want = jb.bake(jp, jcfg, jnp.asarray(occ), jbcfg)
    got = tb.bake(p, cfg, torch.as_tensor(occ), bcfg, device="cpu")
    np.testing.assert_array_equal(got["block_map"].numpy(),
                                  np.asarray(want["block_map"]))
    assert got["n_blocks"] == want["n_blocks"] > 0
    assert 0 < got["n_blocks"] < (32 // block) ** 3   # occupancy prunes
    assert got["pool"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["pool"].float().numpy(),
                               np.asarray(want["pool"], np.float32),
                               rtol=8e-3, atol=1e-3)
    # the gated (empty-cell) sigma rows are exactly -30 on both sides
    gated = np.asarray(want["pool"], np.float32)[:, 0::16] == -30.0
    assert gated.any()
    np.testing.assert_array_equal(got["pool"].float().numpy()[:, 0::16]
                                  == -30.0, gated)


def test_trilerp_w8_matches_jax():
    f = np.random.RandomState(1).uniform(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(tb.trilerp_w8(torch.as_tensor(f)).numpy(),
                               np.asarray(jb.trilerp_w8(jnp.asarray(f))),
                               atol=1e-7)


def test_npz_crosses_both_ways_and_renders_the_same_frame(tmp_path):
    """JAX save_baked -> port load_baked, and port save_baked -> JAX
    load_baked; each side renders the other's artifact like its own."""
    sc = make_scene()
    o = torch.as_tensor(np.array(sc["o"]))
    d = torch.as_tensor(np.array(sc["d"]))

    jax_file = str(tmp_path / "jax_bake.npz")
    jb.save_baked(jax_file, sc["jbaked"], sc["jbcfg"])
    baked, bcfg = tb.load_baked(jax_file, device="cpu")
    assert bcfg == sc["bcfg"]
    assert torch.equal(baked["pool"].view(torch.int16),
                       jax_bf16_to_torch(sc["jbaked"]["pool"])
                       .view(torch.int16))
    ours = render_brick_mxu(baked, sc["cfg"], o, d, 16, 16, bcfg=bcfg,
                            kernel="wl", device="cpu", **FRAME_KW)
    theirs = jax_render(sc["jbaked"], sc["jcfg"], sc["o"], sc["d"], 16, 16,
                        bcfg=sc["jbcfg"], kernel="wl", interpret=True,
                        **FRAME_KW)
    np.testing.assert_allclose(ours["rgb"].numpy(),
                               np.asarray(theirs["rgb"]), atol=2e-3)
    assert int(ours["pairs_rendered"]) == int(theirs["pairs_rendered"])

    port_file = str(tmp_path / "port_bake.npz")
    tb.save_baked(port_file, baked, bcfg)
    jbaked, jbcfg = jb.load_baked(port_file)
    assert jbcfg == sc["jbcfg"]
    np.testing.assert_array_equal(
        np.asarray(jbaked["pool"]).view(np.uint16),
        np.asarray(sc["jbaked"]["pool"]).view(np.uint16))
    again = jax_render(jbaked, sc["jcfg"], sc["o"], sc["d"], 16, 16,
                       bcfg=jbcfg, kernel="wl", interpret=True, **FRAME_KW)
    np.testing.assert_allclose(np.asarray(again["rgb"]),
                               np.asarray(theirs["rgb"]), atol=0)
