"""The block2 marcher and its occupancy tables in the PyTorch port against
JAX on the same numpy inputs (tests/test_march_block.py's scenes).

Tables (pack_occupancy_blocks4, pack_super_liveness, the block2 dict)
must be equal.  The march, on JAX's noise: valid and truncated equal;
ts, xyzs and deltas within atol 1e-6; t_resume equal where finite and
infinite at the same rays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops import grid as jgrid
from google_nerf_tpu.ops import march_block as jmb
from google_nerf_tpu.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops import grid as tgrid
from google_nerf_tpu_torch.ops import march_block as tmb
from google_nerf_tpu_torch.ops.march_seg import _first_k

KEY = jax.random.PRNGKey(0)
SCALE = 0.5
G = 32
MAX_SAMPLES = 256


def make_scene(key, density, n=64):
    occ = jax.random.bernoulli(key, density, (1, G, G, G))
    k1, k2 = jax.random.split(key)
    rays_o = jax.random.uniform(k1, (n, 3), minval=-1.2, maxval=1.2)
    rays_d = jax.random.normal(k2, (n, 3))
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    hits = clamp_near(ray_aabb_intersect(rays_o, rays_d, jnp.zeros(3),
                                         jnp.full((3,), SCALE)), 0.05)
    noise = jax.random.uniform(jax.random.fold_in(key, 3), (n,))
    return [np.array(a) for a in (occ, rays_o, rays_d, hits, noise)]


@pytest.mark.parametrize("density", [0.01, 0.1])
def test_pack_blocks4_equals_jax(density):
    occ = np.array(jax.random.bernoulli(KEY, density, (1, 16, 16, 16)))
    got = tgrid.pack_occupancy_blocks4(torch.as_tensor(occ), 4)
    assert got.dtype == torch.int32 and got.shape == (64, 16)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgrid.pack_occupancy_blocks4(occ, 4)))


@pytest.mark.parametrize("window", [13, 37])
def test_pack_super_liveness_equals_jax(window):
    occ = np.array(jax.random.bernoulli(jax.random.fold_in(KEY, 5), 0.002,
                                          (1, 32, 32, 32)))
    got = tgrid.pack_super_liveness(torch.as_tensor(occ), window, 8)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgrid.pack_super_liveness(occ, window, 8)))


def test_pack_occupancy_block2_and_sizes_equal_jax():
    occ = np.array(jax.random.bernoulli(KEY, 0.03, (1, G, G, G)))
    for ms in (256, 512, 1024):
        for gs in (32, 128):
            assert tmb.block2_group(ms, SCALE, gs) == jmb.block2_group(
                ms, SCALE, gs)
            assert tmb.super_window(ms, SCALE, gs) == jmb.super_window(
                ms, SCALE, gs)
    got = tmb.pack_occupancy_block2(torch.as_tensor(occ),
                                    max_samples=MAX_SAMPLES, scale=SCALE)
    want = jmb.pack_occupancy_block2(occ, max_samples=MAX_SAMPLES,
                                     scale=SCALE)
    for k in ("blocks4", "super"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_first_k_picks_set_entries_in_order():
    rng = np.random.RandomState(0)
    mask = rng.rand(40, 24) < 0.3
    idx, ok = _first_k(torch.as_tensor(mask), 6)
    for r in range(40):
        want = np.flatnonzero(mask[r])[:6]
        assert ok[r].sum() == len(want)
        np.testing.assert_array_equal(idx[r, :len(want)].numpy(), want)


def _march_both(scene, **kw):
    occ, o, d, hits, noise = scene
    occ2 = jmb.pack_occupancy_block2(occ, max_samples=MAX_SAMPLES,
                                     scale=SCALE)
    want = jmb.march_rays_train_block2(o, d, hits, occ2, scale=SCALE,
                                       grid_size=G, max_samples=MAX_SAMPLES,
                                       noise=noise, **kw)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    got = tmb.march_rays_train_block2(
        t(o), t(d), t(hits), {k: t(v) for k, v in occ2.items()},
        scale=SCALE, grid_size=G, max_samples=MAX_SAMPLES, noise=t(noise),
        **kw)
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
    np.testing.assert_array_equal(tr[np.isfinite(tr)], wr[np.isfinite(wr)])
    assert int(got["total_samples"]) == int(want["total_samples"])


@pytest.mark.parametrize("density", [0.005, 0.05])
def test_block2_equals_jax_at_ample_capacity(density):
    """Every super and enough groups kept: no truncation (the setting of
    tests/test_march_block.py::test_block2_matches_dense)."""
    got, want = _march_both(make_scene(KEY, density), k_samples=32,
                            n_keep_super=64, n_keep_groups=MAX_SAMPLES)
    _assert_march_equal(got, want)
    assert got["valid"].any()


@pytest.mark.parametrize("k_samples,n_keep_super,n_keep_groups", [
    (64, 2, 4),        # phase A runs and truncates; groups truncate
    (16, 4, 8),        # the first-k of samples truncates too
    (256, 4, 32)])     # the train setting: every super kept (phase A off)
def test_block2_truncation_equals_jax(k_samples, n_keep_super,
                                      n_keep_groups):
    got, want = _march_both(make_scene(jax.random.fold_in(KEY, 9), 0.2),
                            k_samples=k_samples, n_keep_super=n_keep_super,
                            n_keep_groups=n_keep_groups)
    _assert_march_equal(got, want)
    if n_keep_super < MAX_SAMPLES // 64:
        assert want["truncated"].any()
