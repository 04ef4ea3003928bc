"""The port's data-parallel renderers (parallel/dp.render_test_fast_dp,
render_test_oneshot_dp, render_brick_dp) in a gloo world of two ranks on
the CPU, against the port's serial renderers and against JAX's DP
renderers on make_mesh(2) (mirrors tests/test_dp_render.py, whose
fixtures these are: grid 32, 4 packed levels of 2^12 rows, a 24x20
view, 20% and 10% random occupancy; the brick frame on
test_torch_render_brick_xla.py's 64^3 bake of JAX's weights at 16x16).

Rays are independent, so each rank's shard renders as it does in the
serial frame: rgb, opacity and depth within JAX's atol 1e-5 of the
serial renderer (one thread on both sides), the brick telemetry summed
over the ranks equal to the serial frame's.  Against JAX's DP renderers
on JAX's weights: PERF.md section 6's frame bound, rgb, opacity and
depth atol 2e-3, the brick counters equal."""
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
from google_nerf_tpu.ops.grid import pack_occupancy_u8
from google_nerf_tpu.ops.march_block import pack_occupancy_block2
from google_nerf_tpu.ops.march_seg import required_dilation_radius
from google_nerf_tpu.parallel import dp as jdp
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models.baked import BakedConfig
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_brick import render_brick
from google_nerf_tpu_torch.models.render_test_fast import render_test_fast
from google_nerf_tpu_torch.models.render_test_oneshot import \
    render_test_oneshot
from google_nerf_tpu_torch.parallel.launch import run_world
from test_torch_cli_parity import one_torch_thread  # noqa: F401
from test_torch_dp_ranks import render_cases
from test_torch_render_brick_mxu import jax_bf16_to_torch

N = 2
MODEL = dict(scale=0.5, encoder="packed", grid_size=32, packed_log2_size=12,
             packed_levels=4)
MS = 256
# tests/test_dp_render.py's keywords
FAST = dict(k=8, seg=8, n_segs=8, n_keep=4, max_samples=MS, bucket=64,
            chunk=128)
ONESHOT = dict(max_samples=MS, k=16, n_keep=8, sup=4, n_keep_sup=8,
               chunk=128, straggler_div=8, budget_div=0, drain=True,
               T_threshold=1e-4)
COMPACT = dict(max_samples=MS, k=16, n_keep=8, chunk=120, budget_div=0,
               straggler_div=2, drain=True, T_threshold=1e-4,
               march="block2", compact_main=True)
BRICK = dict(L=64, Lk=16, max_samples=128, pairs_per_ray=16.0)
BRICK_TELEMETRY = ("trunc_tiles", "trunc_rays", "pairs_dropped",
                   "pairs_total")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cases():
    """test_dp_render.py's three cases: (renderer, JAX params, occ_u8,
    rays_o, rays_d, keywords), JAX's arrays."""
    jcfg = JNGPConfig(**MODEL)
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(24, 20))
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    occ = jax.random.bernoulli(jax.random.PRNGKey(3), 0.2,
                               (jcfg.cascades,) + (jcfg.grid_size,) * 3)
    seg_words = pack_occupancy_u8(
        occ, required_dilation_radius(8, jcfg.grid_size, MS, jcfg.scale),
        super_radius=required_dilation_radius(32, jcfg.grid_size, MS,
                                              jcfg.scale))
    bright = dict(params, packed_table=params["packed_table"] * 2e3)
    occ2 = jax.random.bernoulli(jax.random.PRNGKey(6), 0.1,
                                (jcfg.cascades,) + (jcfg.grid_size,) * 3)
    return jcfg, {
        "fast": ("fast", params, pack_occupancy_u8(occ, 2, super_radius=5),
                 o, d, FAST),
        "oneshot": ("oneshot", params, seg_words, o, d, ONESHOT),
        "compact": ("oneshot", bright, pack_occupancy_block2(
            occ2, max_samples=MS, scale=jcfg.scale), o, d, COMPACT)}


def brick_case():
    """test_torch_render_brick_xla.py's bake and 16x16 view."""
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=16,
                      packed_log2_size=12, packed_levels=4)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 1e3
    occ = jnp.ones((jcfg.cascades,) + (jcfg.grid_size,) * 3, bool)
    jbcfg = jbaked.BakedConfig(voxel_res=64, block=8)
    jb = jbaked.bake(params, jcfg, occ, jbcfg)
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(16, 16))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    return jcfg, jbcfg, jb, o, d


@pytest.fixture(scope="module")
def renders():
    jcfg, jcases = cases()
    bj = brick_case()
    cfg = NGPConfig(**MODEL)
    bcfg_model = NGPConfig(scale=0.5, encoder="packed", grid_size=16,
                           packed_log2_size=12, packed_levels=4)
    jb = bj[2]
    baked = dict(block_map=np.asarray(jb["block_map"]),
                 pool=np.asarray(jb["pool"]).view(np.uint16).view(np.int16),
                 rgb_mlp=[np.asarray(w) for w in jb["rgb_mlp"]],
                 n_blocks=int(jb["n_blocks"]))
    bcfg = BakedConfig(voxel_res=64, block=8)
    ranks = run_world(render_cases, N, (
        cfg, {k: (kind, np_tree(p), np_tree(w), np.asarray(o),
                  np.asarray(d), kw)
              for k, (kind, p, w, o, d, kw) in jcases.items()},
        (bcfg_model, baked, bcfg, np.asarray(bj[3]), np.asarray(bj[4]), 16,
         16, BRICK)), timeout=120)
    tb = dict(baked, pool=jax_bf16_to_torch(jb["pool"]),
              block_map=torch.as_tensor(np.array(baked["block_map"])),
              rgb_mlp=[torch.as_tensor(w) for w in baked["rgb_mlp"]])
    return dict(jcfg=jcfg, jcases=jcases, cfg=cfg, brick=bj,
                bcfg_model=bcfg_model, tb=tb, bcfg=bcfg, ranks=ranks)


def serial(renders, name):
    kind, p, w, o, d, kw = renders["jcases"][name]
    fn = render_test_fast if kind == "fast" else render_test_oneshot
    w = ({k: torch.as_tensor(np.asarray(v)) for k, v in w.items()}
         if isinstance(w, dict) else torch.as_tensor(np.asarray(w)))
    return fn(params_from_jax(np_tree(p), "cpu"), renders["cfg"], w,
              torch.as_tensor(np.asarray(o)), torch.as_tensor(np.asarray(d)),
              **kw)


@pytest.mark.parametrize("name", ["fast", "oneshot", "compact"])
def test_dp_render_matches_serial(renders, name, one_torch_thread):
    """Each rank's gathered frame equals the serial frame at atol 1e-5;
    480 rays over 2 ranks, 240 a shard."""
    want = serial(renders, name)
    for out in renders["ranks"]:
        got = out[name]
        assert sorted(got) == ["depth", "opacity", "rgb"]
        for k in got:
            assert got[k].shape == tuple(want[k].shape)
            np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["fast", "oneshot", "compact"])
def test_dp_render_matches_jax_dp(renders, name):
    """The port's DP frame against JAX's DP renderer on make_mesh(2), on
    JAX's weights and occupancy: atol 2e-3."""
    kind, p, w, o, d, kw = renders["jcases"][name]
    fn = (jdp.render_test_fast_dp if kind == "fast"
          else jdp.render_test_oneshot_dp)
    want = fn(p, renders["jcfg"], w, o, d, jdp.make_mesh(N), **kw)
    got = renders["ranks"][0][name]
    for k in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=2e-3,
                                   rtol=0, err_msg=k)


def test_dp_brick_matches_serial_and_jax_dp(renders, one_torch_thread):
    """render_brick_dp against the serial render_brick (atol 1e-5, the
    summed telemetry equal) and JAX's render_brick_dp on make_mesh(2)
    (atol 2e-3, counters equal)."""
    jcfg, jbcfg, jb, o, d = renders["brick"]
    want = render_brick(renders["tb"], renders["bcfg_model"],
                        torch.as_tensor(np.asarray(o)),
                        torch.as_tensor(np.asarray(d)), 16, 16,
                        bcfg=renders["bcfg"], device="cpu", **BRICK)
    jwant = jdp.render_brick_dp(jb, jcfg, o, d, 16, 16, jdp.make_mesh(N),
                                bcfg=jbcfg, **BRICK)
    assert int(want["pairs_total"]) > 0
    for out in renders["ranks"]:
        got = out["brick"]
        for k in ("rgb", "opacity", "depth"):
            np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
            np.testing.assert_allclose(got[k], np.asarray(jwant[k]),
                                       atol=2e-3, rtol=0, err_msg=k)
        for k in BRICK_TELEMETRY:
            assert int(got[k]) == int(want[k]) == int(jwant[k]), k
