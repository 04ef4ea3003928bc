"""The segment marcher and its word grid in the PyTorch port against JAX on
the same numpy inputs (the scenes of tests/test_march_seg.py and
tests/test_march_block.py).

pack_occupancy_u8 and super_any_live must be equal, and so must
required_dilation_radius and the cascade helpers.  The march, on JAX's
noise: valid and truncated equal; ts, xyzs and deltas within atol 1e-6
(the block2 marcher's tolerance); t_resume equal where finite and
infinite at the same rays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops import grid as jgrid
from google_nerf_tpu.ops import march_block as jmb
from google_nerf_tpu.ops import march_seg as jms
from google_nerf_tpu.ops import marching as jmarch
from google_nerf_tpu.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops import grid as tgrid
from google_nerf_tpu_torch.ops import march_block as tmb
from google_nerf_tpu_torch.ops import march_seg as tms
from google_nerf_tpu_torch.ops import marching as tmarch

KEY = jax.random.PRNGKey(0)
G = 32
MAX_SAMPLES = 256


def t(a):
    return torch.as_tensor(np.array(a))


def make_scene(key, density, scale=0.5, cascades=1, n=64):
    occ = jax.random.bernoulli(key, density, (cascades, G, G, G))
    k1, k2 = jax.random.split(key)
    rays_o = jax.random.uniform(k1, (n, 3), minval=-1.2, maxval=1.2) * scale
    rays_d = jax.random.normal(k2, (n, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    hits = clamp_near(ray_aabb_intersect(rays_o, rays_d, jnp.zeros(3),
                                         jnp.full((3,), scale)), 0.05)
    noise = jax.random.uniform(jax.random.fold_in(key, 3), (n,))
    return [np.array(a) for a in (occ, rays_o, rays_d, hits, noise)]


@pytest.mark.parametrize("radius,super_radius,cascades",
                         [(1, 0, 1), (3, 7, 1), (2, 5, 2)])
def test_pack_occupancy_u8_equals_jax(radius, super_radius, cascades):
    occ = np.array(jax.random.bernoulli(jax.random.fold_in(KEY, radius), 0.1,
                                        (cascades, G, G, G)))
    got = tgrid.pack_occupancy_u8(t(occ), radius, super_radius=super_radius)
    assert got.dtype == torch.int32 and got.shape == occ.shape
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgrid.pack_occupancy_u8(
            occ, radius, super_radius=super_radius)))


def test_dilation_radius_and_cascade_helpers_equal_jax():
    for seg in (1, 8, 32):
        for gs in (32, 128):
            for ms in (256, 512, 1024):
                for scale in (0.5, 1.0, 4.0):
                    assert tms.required_dilation_radius(
                        seg, gs, ms, scale) == jms.required_dilation_radius(
                        seg, gs, ms, scale)
                    assert tms._word_group(seg, 3 ** 0.5 / ms, scale, gs) \
                        == jms._word_group(seg, 3 ** 0.5 / ms, scale, gs)
    rng = np.random.default_rng(0)
    xyz = (rng.uniform(-3, 3, (500, 3)) * rng.uniform(0, 1, (500, 1))
           ).astype(np.float32)
    xyz[:3] = 0.0
    dt = rng.uniform(0, 0.2, (500,)).astype(np.float32)
    np.testing.assert_array_equal(
        tmarch.mip_from_pos(t(xyz), 4).numpy(),
        np.asarray(jmarch.mip_from_pos(xyz, 4)))
    np.testing.assert_array_equal(
        tmarch.mip_from_dt(t(dt), 32, 4).numpy(),
        np.asarray(jmarch.mip_from_dt(dt, 32, 4)))


def _march_both(scene, scale=0.5, cascades=1, seg=8, sup=0, radius_seg=None,
                **kw):
    occ, o, d, hits, noise = scene
    r1 = jms.required_dilation_radius(radius_seg or seg, G, MAX_SAMPLES,
                                      scale)
    r2 = (jms.required_dilation_radius(seg * sup, G, MAX_SAMPLES, scale)
          if sup > 1 else 0)
    occ_u8 = np.array(jgrid.pack_occupancy_u8(occ, r1, super_radius=r2))
    mk = dict(cascades=cascades, scale=scale, grid_size=G,
              max_samples=MAX_SAMPLES, seg=seg, sup=sup, **kw)
    want = jms.march_rays_train_seg(o, d, hits, occ_u8, noise=noise, **mk)
    got = tms.march_rays_train_seg(t(o), t(d), t(hits), t(occ_u8),
                                   noise=t(noise), **mk)
    return got, {k: np.asarray(v) for k, v in want.items()}


def _assert_march_equal(got, want):
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["truncated"].numpy(),
                                  want["truncated"])
    for k in ("ts", "xyzs", "deltas", "dirs"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    tr, wr = got["t_resume"].numpy(), want["t_resume"]
    np.testing.assert_array_equal(np.isfinite(tr), np.isfinite(wr))
    np.testing.assert_allclose(tr[np.isfinite(tr)], wr[np.isfinite(wr)],
                               atol=1e-6, rtol=0)
    assert int(got["total_samples"]) == int(want["total_samples"])


CASES = {
    # two phases, every segment kept (tests/test_march_seg.py's dense case)
    "two_phase": dict(density=0.05, kw=dict(k_samples=32, n_keep=32)),
    # segment and sample truncation: t_resume from both
    "truncated": dict(density=0.2, kw=dict(k_samples=12, n_keep=4)),
    # three phases, super-segments of 4
    "three_phase": dict(density=0.05, kw=dict(k_samples=32, n_keep=32,
                                              sup=4, n_keep_sup=8)),
    "three_phase_truncated": dict(density=0.2, kw=dict(
        k_samples=16, n_keep=6, sup=4, n_keep_sup=2)),
    # segments spanning >= 2 cells: dilated bit 1 and per-candidate bit 0
    "bit_lookups": dict(density=0.05, kw=dict(k_samples=48, n_keep=8,
                                              seg=32)),
    # two cascades: the mip lookup
    "cascades": dict(density=0.05, scale=1.0, cascades=2,
                     kw=dict(k_samples=32, n_keep=16, sup=4, n_keep_sup=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_march_seg_equals_jax(case):
    c = CASES[case]
    scale, cascades = c.get("scale", 0.5), c.get("cascades", 1)
    scene = make_scene(jax.random.fold_in(KEY, len(case)), c["density"],
                       scale=scale, cascades=cascades)
    got, want = _march_both(scene, scale=scale, cascades=cascades, **c["kw"])
    _assert_march_equal(got, want)
    assert got["valid"].any()
    if "truncated" in case:
        assert got["truncated"].any()


@pytest.mark.parametrize("density", [0.002, 0.03])
def test_super_any_live_equals_jax(density):
    occ, o, d, hits, _ = make_scene(jax.random.fold_in(KEY, 7), density,
                                    n=256)
    occ2 = jmb.pack_occupancy_block2(occ, max_samples=MAX_SAMPLES, scale=0.5)
    want = np.asarray(jmb.super_any_live(o, d, hits, occ2, scale=0.5,
                                         grid_size=G,
                                         max_samples=MAX_SAMPLES))
    got = tmb.super_any_live(t(o), t(d), t(hits),
                             {k: t(v) for k, v in occ2.items()}, scale=0.5,
                             grid_size=G, max_samples=MAX_SAMPLES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
