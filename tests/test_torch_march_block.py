"""The block marchers (one-phase block and two-phase block2) and their
occupancy tables in the PyTorch port against JAX on the same numpy inputs
(tests/test_march_block.py's scenes and cases).

Tables (pack_occupancy_blocks, pack_occupancy_blocks4,
pack_super_liveness, the block2 dict) and group sizes must be equal.
The march, on JAX's noise: valid and truncated equal; ts, xyzs and
deltas within atol 1e-6; t_resume equal where finite and infinite at
the same rays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops import grid as jgrid
from google_nerf_tpu.ops import march_block as jmb
from google_nerf_tpu.ops.marching import march_rays_train as jax_dense
from google_nerf_tpu.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops import grid as tgrid
from google_nerf_tpu_torch.ops import march_block as tmb
from google_nerf_tpu_torch.ops.march_seg import _first_k
from google_nerf_tpu_torch.ops.marching import march_rays_train

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


# ------------------------------------------------ the one-phase marcher

def test_block_group_span():
    """The auto group keeps g consecutive candidates within BLOCK-1 cells
    per axis, and equals JAX's."""
    for ms in (256, 512, 1024):
        for gs in (32, 128):
            g = tmb.block_group(ms, SCALE, gs)
            assert g == jmb.block_group(ms, SCALE, gs)
            assert g >= 1 and ms % g == 0
            cells_per_step = (3.0 ** 0.5 / ms) * gs / (2.0 * min(0.5, SCALE))
            assert (g - 1) * cells_per_step < 7.0


@pytest.mark.parametrize("density", [0.01, 0.1])
def test_pack_occupancy_blocks_bits(density):
    """Every word equal to JAX's, and the bit layout checked directly:
    bit dx*64 + dy*8 + dz of row (ax, ay, az) is occ at the offset
    cell (out of the grid: 0)."""
    occ = np.array(jax.random.bernoulli(KEY, density, (1, 16, 16, 16)))
    blocks = tgrid.pack_occupancy_blocks(torch.as_tensor(occ))
    assert blocks.dtype == torch.int32 and blocks.shape == (16 ** 3, 16)
    blocks = blocks.numpy()
    np.testing.assert_array_equal(
        blocks, np.asarray(jgrid.pack_occupancy_blocks(occ)))
    rng = np.random.default_rng(0)
    for _ in range(200):
        ax, ay, az = rng.integers(0, 16, 3)
        dx, dy, dz = rng.integers(0, 8, 3)
        o = dx * 64 + dy * 8 + dz
        bit = (blocks[(ax * 16 + ay) * 16 + az][o // 32] >> (o % 32)) & 1
        x, y, z = ax + dx, ay + dy, az + dz
        want = occ[0, x, y, z] if max(x, y, z) < 16 else False
        assert bool(bit) == bool(want), (ax, ay, az, dx, dy, dz)


def _block_both(scene, **kw):
    occ, o, d, hits, noise = scene
    blocks = jgrid.pack_occupancy_blocks(occ)
    want = jmb.march_rays_train_block(o, d, hits, blocks, scale=SCALE,
                                      grid_size=G, max_samples=MAX_SAMPLES,
                                      noise=noise, **kw)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    got = tmb.march_rays_train_block(
        t(o), t(d), t(hits), tgrid.pack_occupancy_blocks(t(occ)),
        scale=SCALE, grid_size=G, max_samples=MAX_SAMPLES, noise=t(noise),
        **kw)
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("density", [0.005, 0.05])
@pytest.mark.parametrize("group", [0, 4])
def test_block_matches_dense(density, group):
    """At ample group capacity the block marcher's samples are the dense
    lattice marcher's (the port's and JAX's): valid equal, ts and deltas
    within atol 1e-6; and the whole march equals JAX's block march."""
    scene = make_scene(KEY, density)
    occ, o, d, hits, noise = scene
    nkg = MAX_SAMPLES // (group or tmb.block_group(MAX_SAMPLES, SCALE, G))
    got, want = _block_both(scene, k_samples=32, group=group,
                            n_keep_groups=nkg)
    _assert_march_equal(got, want)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    dense = march_rays_train(t(o), t(d), t(hits), t(occ), cascades=1,
                             scale=SCALE, exp_step_factor=0.0, grid_size=G,
                             max_samples=MAX_SAMPLES, k_samples=32,
                             noise=t(noise))
    jd = jax_dense(o, d, hits, occ, cascades=1, scale=SCALE,
                   exp_step_factor=0.0, grid_size=G, max_samples=MAX_SAMPLES,
                   k_samples=32, noise=noise)
    np.testing.assert_array_equal(dense["valid"].numpy(),
                                  np.asarray(jd["valid"]))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  dense["valid"].numpy())
    for k in ("ts", "deltas"):
        np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
    assert int(got["total_samples"]) == int(dense["total_samples"]) > 0


@pytest.mark.parametrize("k_samples,n_keep_groups", [
    (64, 2),          # groups truncate
    (16, 8),          # the first-k of samples truncates too
    (64, 0)])         # the default window: ceil(k_samples / g) groups
def test_block_truncation_keeps_prefix_groups(k_samples, n_keep_groups):
    """Truncated marches equal JAX's (valid, truncated, t_resume), and the
    kept samples are a prefix of the dense march's: every kept t is a
    dense sample and the kept groups are each ray's first live ones."""
    scene = make_scene(jax.random.fold_in(KEY, 9), 0.2)
    occ, o, d, hits, noise = scene
    got, want = _block_both(scene, k_samples=k_samples,
                            n_keep_groups=n_keep_groups)
    _assert_march_equal(got, want)
    assert want["truncated"].any()
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    dense = march_rays_train(t(o), t(d), t(hits), t(occ), cascades=1,
                             scale=SCALE, exp_step_factor=0.0, grid_size=G,
                             max_samples=MAX_SAMPLES, k_samples=MAX_SAMPLES,
                             noise=t(noise))
    ts_b, v_b = got["ts"].numpy(), got["valid"].numpy()
    ts_d, v_d = dense["ts"].numpy(), dense["valid"].numpy()
    for r in range(ts_b.shape[0]):
        kept = np.sort(ts_b[r][v_b[r]])
        ref = np.sort(ts_d[r][v_d[r]])
        assert len(kept) <= len(ref)
        if len(kept):
            assert np.all(np.isin(np.round(kept, 6), np.round(ref, 6)))
            assert (ref <= kept[-1] + 1e-6).sum() == len(kept)
