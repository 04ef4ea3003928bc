"""The baked field (baked_field, baked_apply, make_baked_apply) in the
PyTorch port against google_nerf_tpu/models/baked.py on JAX's own bake,
carried to torch bit for bit, at the one-shot fixture's scale (grid 32,
15% occupancy, a 64^3 bake of 8^3 bricks).

h is rounded to bf16 after the 8-corner sum on both sides: the port's h
must lie within one bf16 step of JAX's, and wherever h[0] equals JAX's,
sigma = exp(h[0]) must too, up to one float32 step (XLA's exp and
torch's differ in the last bit on ~1% of the samples).  The one-shot
frame over the baked field (bench.py's baked_oneshot settings at toy
size) is held to the frame tolerance, rgb/opacity/depth atol 2e-3, with
equal drain trips."""
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
from google_nerf_tpu.models.render_test_oneshot import \
    render_test_oneshot as jax_oneshot
from google_nerf_tpu.ops.march_block import pack_occupancy_block2
from google_nerf_tpu_torch.models import baked as tbaked
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_test_oneshot import \
    render_test_oneshot
from test_torch_render_brick_mxu import jax_bf16_to_torch

MS = 256
BCFG = dict(voxel_res=64, block=8)


@pytest.fixture(scope="module")
def scene():
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=32,
                      packed_log2_size=12, packed_levels=4)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 2e3
    occ = jax.random.bernoulli(jax.random.PRNGKey(3), 0.15,
                               (jcfg.cascades,) + (jcfg.grid_size,) * 3)
    jb = jbaked.bake(params, jcfg, occ, jbaked.BakedConfig(**BCFG))
    tb = dict(block_map=torch.as_tensor(np.array(jb["block_map"])),
              pool=jax_bf16_to_torch(jb["pool"]),
              rgb_mlp=[torch.as_tensor(np.array(w)) for w in jb["rgb_mlp"]],
              n_blocks=jb["n_blocks"])
    return dict(jcfg=jcfg, jb=jb, tb=tb, occ=occ,
                cfg=NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                              packed_log2_size=12, packed_levels=4))


def _bf16_step(x):
    """The spacing of bf16 values at |x| (float32 spacing << 16)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


def test_baked_field_and_apply_equal_jax(scene):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.55, 0.55, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    bc_j, bc_t = jbaked.BakedConfig(**BCFG), tbaked.BakedConfig(**BCFG)
    # every block of this bake is occupied: empty a third of them
    bm = np.array(scene["jb"]["block_map"])
    bm[::3] = -1
    jb = dict(scene["jb"], block_map=jnp.asarray(bm))
    tb = dict(scene["tb"], block_map=torch.as_tensor(bm))
    sig_j, h_j = (np.asarray(a) for a in jbaked.baked_field(
        jb, scene["jcfg"], bc_j, jnp.asarray(x)))
    sig_t, h_t = (a.numpy() for a in tbaked.baked_field(
        tb, scene["cfg"], bc_t, torch.as_tensor(x)))
    assert (sig_j == 0).any() and (sig_j > 0).any()   # empty and full blocks
    assert np.all(np.abs(h_t - h_j) <= _bf16_step(h_j))
    same = h_t[:, 0] == h_j[:, 0]
    assert same.mean() > 0.9
    np.testing.assert_array_equal(sig_t == 0, sig_j == 0)
    assert np.all(np.abs(sig_t - sig_j)[same] <= np.spacing(sig_j[same]))
    np.testing.assert_allclose(sig_t, sig_j, rtol=2e-2)
    # the baked field with the live rgb head
    a_j = jbaked.baked_apply(jb, scene["jcfg"], bc_j, jnp.asarray(x),
                             jnp.asarray(d))
    a_t = tbaked.make_baked_apply(bc_t)(tb, scene["cfg"],
                                        torch.as_tensor(x),
                                        torch.as_tensor(d))
    np.testing.assert_array_equal(a_t[0].numpy(), sig_t)
    np.testing.assert_allclose(a_t[1].numpy(), np.asarray(a_j[1]), atol=2e-3)


def test_oneshot_over_baked_field_equals_jax(scene):
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(24, 20))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    occ2 = pack_occupancy_block2(scene["occ"], max_samples=MS, scale=0.5)
    kw = dict(max_samples=MS, T_threshold=1e-2, k=32, budget_div=0,
              straggler_div=2, drain=True, march="block2", compact_main=True,
              chunk=128)
    want = jax_oneshot(scene["jb"], scene["jcfg"], occ2, o, d,
                       apply_fn=jbaked.make_baked_apply(
                           jbaked.BakedConfig(**BCFG)), **kw)
    got = render_test_oneshot(
        scene["tb"], scene["cfg"],
        {k: torch.as_tensor(np.array(v)) for k, v in occ2.items()},
        torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)),
        apply_fn=tbaked.make_baked_apply(tbaked.BakedConfig(**BCFG)), **kw)
    for k in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3, rtol=0, err_msg=k)
    assert got["drain_trips"] == int(want["drain_trips"]) > 1
    assert int(got["alive_after_main"]) == int(want["alive_after_main"])
