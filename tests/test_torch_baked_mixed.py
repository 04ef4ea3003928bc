"""The mixed-resolution bake (bake_mixed, pad_bricks) in the PyTorch port
against google_nerf_tpu/models/baked_mixed.py, on the content blob of
tests/test_baked_mixed.py (grid 16, a 2^10-row packed table scaled by
2e3; its view at 16x16) at 64^3 / 32^3 bf16 bakes, with JAX params
carried to torch.

The merge must equal JAX's: the bricks kept, their AABBs, pool bases and
the stats (the error percentiles to their printed 3 decimals, within one
step of them).  The pool as the bake pool row of PERF.md (rtol 8e-3,
atol 1e-3: one bf16 rounding of f32 values that differ in the last
bits).  The padded mixed frame through K1's plain version against JAX's
worklist frame in interpret mode on JAX's padded mixed bake: the frame
tolerance, rgb/opacity atol 2e-3, counters equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core.rays import get_ray_directions, get_rays
from google_nerf_tpu.models import baked_mixed as jmixed
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp
from google_nerf_tpu.models.render_brick_mxu import \
    render_brick_mxu as jax_render
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models import baked_mixed as tmixed
from google_nerf_tpu_torch.models.baked import BakedConfig, bake
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_brick_mxu import render_brick_mxu
from test_torch_render_brick_mxu import COUNTERS

MIX = dict(vres_fine=64, vres_coarse=32, block=8, dtype="bfloat16",
           tol_sigma=0.12, tol_feat=0.15)
PAD = 256       # bench.py pads to 4096 bricks; 256 keeps the pool small
FRAME = dict(L=32, exact_cull=16, kernel="wl", pbatch=8, segment_slots=8,
             drain_tiles=16, drain_L=64, drain_xc=64, max_samples=64,
             T_threshold=1e-2, chunk_tiles=16, macro_tiles=0, macro_L=0)
W = H = 16


@pytest.fixture(scope="module")
def scene():
    jcfg = JNGPConfig(scale=0.5, encoder="packed", packed_log2_size=10,
                      grid_size=16)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 2e3
    occ = np.zeros((jcfg.cascades, 16, 16, 16), bool)
    occ[0, 4:10, 5:11, 6:12] = True     # a content blob
    K = jnp.asarray([[12.0, 0, W / 2], [0, 12.0, H / 2], [0, 0, 1]])
    pose = jnp.broadcast_to(
        jnp.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, -1.4]]),
        (H * W, 3, 4))
    o, d = get_rays(get_ray_directions(H, W, K), pose)
    jm = jmixed.bake_mixed(params, jcfg, jnp.asarray(occ), **MIX)
    cfg = NGPConfig(scale=0.5, encoder="packed", packed_log2_size=10,
                    grid_size=16)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    tm = tmixed.bake_mixed(tparams, cfg, torch.as_tensor(occ), device="cpu",
                           **MIX)
    return dict(jcfg=jcfg, cfg=cfg, occ=occ, tparams=tparams, jm=jm, tm=tm,
                o=o, d=d)


def test_bake_mixed_equals_jax(scene):
    (jb, jbc, jgeo, jst), (tb, tbc, tgeo, tst) = scene["jm"], scene["tm"]
    assert 0 < tst["n_coarse"] and 0 < tst["n_fine_kept"]   # a partial merge
    for k in ("n_fine_total", "n_fine_kept", "n_coarse", "bricks_saved_frac"):
        assert tst[k] == jst[k], k
    for k in ("sigma", "feat"):
        np.testing.assert_allclose(tst["err_pct"][k], jst["err_pct"][k],
                                   atol=1e-3 + 1e-9, rtol=0)
    assert tb["n_blocks"] == jb["n_blocks"] and tbc == BakedConfig(
        voxel_res=jbc.voxel_res, block=jbc.block, dtype=jbc.dtype)
    for t, j in zip(tgeo, jgeo):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_allclose(tb["pool"].float().numpy(),
                               np.asarray(jb["pool"], np.float32),
                               rtol=8e-3, atol=1e-3)


def test_pad_bricks_equals_jax(scene):
    jb, _, jgeo, _ = scene["jm"]
    tb, _, tgeo, _ = scene["tm"]
    jb2, jgeo2 = jmixed.pad_bricks(jb, jgeo, mult=PAD)
    tb2, tgeo2 = tmixed.pad_bricks(dict(tb, poolT=tb["pool"]), tgeo,
                                   mult=PAD)
    assert tb2["n_blocks"] == jb2["n_blocks"] == PAD
    assert "poolT" not in tb2
    for t, j in zip(tgeo2, jgeo2):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tb2["pool"].shape == jb2["pool"].shape
    assert not tb2["pool"][tb["pool"].shape[0]:].any()
    assert tmixed.pad_bricks(tb2, tgeo2, mult=PAD)[0] is tb2


def test_padded_mixed_frame_through_k1_equals_jax(scene):
    jb, jbc, jgeo, _ = scene["jm"]
    tb, tbc, tgeo, _ = scene["tm"]
    jb2, jgeo2 = jmixed.pad_bricks(jb, jgeo, mult=PAD)
    tb2, tgeo2 = tmixed.pad_bricks(tb, tgeo, mult=PAD)
    want = jax_render(jb2, scene["jcfg"], scene["o"], scene["d"], W, H,
                      bcfg=jbc, geometry=jgeo2, interpret=True, **FRAME)
    got = render_brick_mxu(tb2, scene["cfg"],
                           torch.as_tensor(np.array(scene["o"])),
                           torch.as_tensor(np.array(scene["d"])), W, H,
                           bcfg=tbc, geometry=tgeo2, device="cpu", **FRAME)
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3, rtol=0, err_msg=k)
    for k in COUNTERS:
        assert int(got[k]) == int(want[k]), k
    assert int(got["pairs_undrained"]) == 0
    assert float(got["opacity"].max()) > 0.1


def test_bake_mixed_drops_the_inputs_pools(scene):
    """The input bakes lose their pools and any cached poolT/poolRGBA, so
    the caller's references free them as the pool is assembled."""
    cfg, tparams, occ = scene["cfg"], scene["tparams"], scene["occ"]
    fine = bake(tparams, cfg, occ, BakedConfig(voxel_res=64, block=8),
                device="cpu")
    coarse = bake(tparams, cfg, occ, BakedConfig(voxel_res=32, block=8),
                  device="cpu")
    for b in (fine, coarse):
        b["poolT"] = b["pool"].clone()
        b["poolRGBA"] = b["pool"].clone()
    baked, _, _, st = tmixed.bake_mixed(tparams, cfg, occ, fine=fine,
                                        coarse=coarse, device="cpu", **MIX)
    for b in (fine, coarse):
        assert not {"pool", "poolT", "poolRGBA"} & set(b)
    assert st == scene["tm"][3]
    torch.testing.assert_close(baked["pool"], scene["tm"][0]["pool"],
                               rtol=0, atol=0)
