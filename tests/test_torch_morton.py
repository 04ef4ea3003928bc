"""Morton codes, bitfield packing and ray/sphere intersection of the
PyTorch port against JAX (tests/test_ops_basic.py's cases) on the same
numpy inputs.  Codes, coordinates and bits are equal; ray/sphere hits
within 1e-6 of JAX's and tests/test_ops_basic.py's golden within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops import morton as jm
from google_nerf_tpu.ops.ray_aabb import ray_sphere_intersect as jax_sphere
from google_nerf_tpu_torch.ops import morton as tm
from google_nerf_tpu_torch.ops.ray_aabb import ray_sphere_intersect


def _morton_ref(x, y, z):
    out = 0
    for i in range(10):
        out |= ((x >> i) & 1) << (3 * i)
        out |= ((y >> i) & 1) << (3 * i + 1)
        out |= ((z >> i) & 1) << (3 * i + 2)
    return out


def test_morton_roundtrip_and_golden_equal_jax():
    coords = np.random.RandomState(0).randint(0, 1024, (256, 3)).astype(
        np.int32)
    coords[:2] = [[1023, 1023, 1023], [0, 0, 0]]    # every bit, and none
    codes = tm.morton3d(torch.as_tensor(coords))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jm.morton3d(coords)))
    np.testing.assert_array_equal(
        codes.numpy(), np.array([_morton_ref(*c) for c in coords]))
    inv = tm.morton3d_invert(codes)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy(), coords)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jm.morton3d_invert(np.asarray(codes))))


def test_morton_is_bijection_on_small_grid():
    g = 8
    xs, ys, zs = np.meshgrid(range(g), range(g), range(g), indexing="ij")
    coords = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.int32)
    codes = tm.morton3d(torch.as_tensor(coords)).numpy()
    assert len(np.unique(codes)) == g ** 3 and codes.max() == g ** 3 - 1
    np.testing.assert_array_equal(codes, np.asarray(jm.morton3d(coords)))


@pytest.mark.parametrize("threshold", [0.0, 0.7])
def test_packbits_unpackbits_equal_jax(threshold):
    grid = np.random.RandomState(1).randn(4 * 64).astype(np.float32)
    bf = tm.packbits(torch.as_tensor(grid), threshold)
    assert bf.dtype == torch.uint8 and bf.shape == (32,)
    np.testing.assert_array_equal(
        bf.numpy(), np.asarray(jm.packbits(jnp.asarray(grid), threshold)))
    unpacked = tm.unpackbits(bf)
    np.testing.assert_array_equal(unpacked.numpy(), grid > threshold)
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(jm.unpackbits(np.asarray(bf))))


def test_ray_sphere_equals_jax():
    o = np.array([[0.0, 0.0, -3.0], [0.0, 5.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    hits = ray_sphere_intersect(torch.as_tensor(o), torch.as_tensor(d),
                                torch.zeros(3), 1.0).numpy()
    np.testing.assert_allclose(hits[0], [2.0, 4.0], atol=1e-5)
    np.testing.assert_allclose(hits[1], [-1, -1], atol=1e-6)
    rng = np.random.RandomState(2)
    o = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    d = rng.randn(300, 3).astype(np.float32)
    c = np.array([0.1, -0.2, 0.3], np.float32)
    got = ray_sphere_intersect(torch.as_tensor(o), torch.as_tensor(d), c,
                               0.9).numpy()
    want = np.asarray(jax_sphere(o, d, c, 0.9))
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert 0 < (got[:, 0] >= 0).sum() < len(got)    # hits and misses
