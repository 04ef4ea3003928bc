"""The PyTorch port's worklist frame (render_brick_mxu, kernel="wl")
against the JAX frame in interpret mode on the same baked field, at the
16x16 setup of tests/test_render_brick_mxu.py.

Frame tolerance: rgb/opacity atol 2e-3, the tolerance JAX's own tests
hold two implementations of the same kernel function to
(test_tp_kernel_frame_matches_t_kernel); the counters must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core.rays import get_rays as jax_get_rays
from google_nerf_tpu.data.synthetic import SyntheticDataset as JaxDataset
from google_nerf_tpu.models.baked import BakedConfig as JBakedConfig
from google_nerf_tpu.models.baked import bake as jax_bake
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp as jax_init_ngp
from google_nerf_tpu.models.render_brick_mxu import \
    render_brick_mxu as jax_render
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models import render_brick_mxu as trbm
from google_nerf_tpu_torch.models.baked import BakedConfig, bake
from google_nerf_tpu_torch.models.ngp import NGPConfig

COUNTERS = ("pairs_undrained", "trunc_tiles", "pairs_rendered", "dma_slots")


def jax_bf16_to_torch(a):
    """A JAX bf16 array as a torch bf16 tensor (bit copy)."""
    return torch.from_numpy(
        np.asarray(a).view(np.uint16).view(np.int16).copy()
    ).view(torch.bfloat16)


def make_scene():
    """The JAX scene fixture's setup, with its bake carried to torch."""
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=16,
                      packed_log2_size=12, packed_levels=4)
    params = jax_init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 1e3
    occ = jnp.ones((jcfg.cascades,) + (jcfg.grid_size,) * 3, bool)
    jbcfg = JBakedConfig(voxel_res=32, block=8)
    jbaked = jax_bake(params, jcfg, occ, jbcfg)
    baked = dict(block_map=torch.as_tensor(np.array(jbaked["block_map"])),
                 pool=jax_bf16_to_torch(jbaked["pool"]),
                 rgb_mlp=[torch.as_tensor(np.array(w))
                          for w in jbaked["rgb_mlp"]],
                 n_blocks=jbaked["n_blocks"])
    ds = JaxDataset(split="test", n_images=1, img_wh=(16, 16))
    o, d = jax_get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=16,
                    packed_log2_size=12, packed_levels=4)
    return dict(jcfg=jcfg, jbcfg=jbcfg, jbaked=jbaked, params=params,
                occ=occ, cfg=cfg, bcfg=BakedConfig(voxel_res=32, block=8),
                baked=baked, o=o, d=d)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _frames(sc, baked=None, **kw):
    jax_out = jax_render(sc["jbaked"], sc["jcfg"], sc["o"], sc["d"], 16, 16,
                         bcfg=sc["jbcfg"], kernel="wl", interpret=True, **kw)
    out = trbm.render_brick_mxu(
        sc["baked"] if baked is None else baked, sc["cfg"],
        torch.as_tensor(np.array(sc["o"])),
        torch.as_tensor(np.array(sc["d"])), 16, 16, bcfg=sc["bcfg"],
        kernel="wl", device="cpu", **kw)
    return out, jax_out


def _assert_frame(out, jax_out):
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(jax_out["rgb"]),
                               atol=2e-3)
    np.testing.assert_allclose(out["opacity"].numpy(),
                               np.asarray(jax_out["opacity"]), atol=2e-3)
    for k in COUNTERS:
        assert int(out[k]) == int(jax_out[k]), k


FRAME_KW = dict(max_samples=64, T_threshold=1e-2, L=64, exact_cull=16,
                pbatch=2, drain_tiles=4, drain_L=64, drain_xc=32,
                segment_slots=8)


@pytest.mark.parametrize("macro_tiles", [0, 8])
def test_worklist_frame_matches_jax(scene, macro_tiles):
    """The segmented worklist frame (mirrors the JAX
    test_worklist_frame_matches_segmented setup); macro_tiles=8 drives the
    hierarchical cull (4 tiles here, so groups of 4)."""
    out, jax_out = _frames(scene, macro_tiles=macro_tiles, **FRAME_KW)
    _assert_frame(out, jax_out)
    assert int(out["pairs_undrained"]) == 0
    assert int(out["pairs_rendered"]) > 0


def test_worklist_cap_overflow_drains_like_jax(scene, monkeypatch):
    """wl_cap=1 leaves nearly every group to the exact drain, which runs
    K2's plain version here; frame and counters match JAX."""
    calls = []
    real = trbm.brick_field_tiles_tp

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(trbm, "brick_field_tiles_tp", counting)
    out, jax_out = _frames(scene, macro_tiles=0, wl_cap=1, **FRAME_KW)
    assert calls, "the drain did not run"
    _assert_frame(out, jax_out)


def test_unported_kernels_raise(scene):
    """A kernel name the port does not have raises, and so does
    segment_slots with a kernel that takes no init carry (n, t), where
    JAX asserts."""
    kw = dict(bcfg=scene["bcfg"], device="cpu")
    rays = (torch.zeros(256, 3), torch.ones(256, 3), 16, 16)
    with pytest.raises(ValueError, match="not in"):
        trbm.render_brick_mxu(scene["baked"], scene["cfg"], *rays,
                              kernel="mxu", **kw)
    for kernel in ("n", "t"):
        with pytest.raises(ValueError, match="segment_slots"):
            trbm.render_brick_mxu(scene["baked"], scene["cfg"], *rays,
                                  kernel=kernel, segment_slots=8, **kw)


def test_weights_end_to_end_match_jax(scene):
    """JAX init_ngp params -> params_from_jax -> port bake -> port frame
    agrees with the all-JAX frame."""
    tree = jax.tree_util.tree_map(np.asarray, scene["params"])
    params = params_from_jax(tree, device="cpu")
    baked = bake(params, scene["cfg"], torch.as_tensor(
        np.array(scene["occ"])), scene["bcfg"], device="cpu")
    out, jax_out = _frames(scene, baked=baked, macro_tiles=0, **FRAME_KW)
    _assert_frame(out, jax_out)
