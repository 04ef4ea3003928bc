"""Occupancy-grid maintenance of the PyTorch port against JAX
(tests/test_grid.py's cases) on the same numpy inputs and JAX's draws.

mark_invisible_cells, _segment_max_dense and _erode must be equal.
update_density_grid, warmup and sampled, on the draws JAX makes from its
key: the grid within rtol 1e-5 (f32 sums in another order in the mean
density; an exp of the same f32 input), occ equal except at cells within
1e-6 relative of the threshold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops import grid as jgrid
from google_nerf_tpu_torch.ops import grid as tgrid

G = 32
SCALE = 0.5
CENTERS = np.array([[0.1, -0.05, 0.0], [-0.2, 0.15, 0.1]], np.float32)


def _density(x, lib):
    """A smooth two-blob field of adds, products and one division (each
    exact to the rounding in both libraries), written once for jnp and
    torch."""
    c = lib.asarray(CENTERS) if lib is jnp else torch.as_tensor(CENTERS)
    d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    return (40.0 / (1.0 + d2 * 400.0)).sum(-1)


def jax_draws(key, warmup, sample_div=4):
    """update_density_grid's draws from its key (grid.py:179-199)."""
    kc = jax.random.fold_in(key, 0)
    d = {}
    n = G ** 3
    if not warmup:
        m = G ** 3 // sample_div
        k1, k2, _ = jax.random.split(kc, 3)
        d["coords_u"] = jax.random.randint(k1, (m, 3), 0, G, dtype=jnp.int32)
        d["u"] = jax.random.uniform(k2, (m,))
        d["rand_idx"] = jax.random.randint(jax.random.fold_in(k2, 1), (m,),
                                           0, G ** 3)
        n = 2 * m
    d["jitter"] = jax.random.uniform(jax.random.fold_in(kc, 7), (n, 3))
    return [{k: torch.as_tensor(np.array(v)) for k, v in d.items()}]


def test_cells_to_world_equals_jax():
    coords = tgrid.cell_coords(G, device="cpu")
    np.testing.assert_array_equal(coords.numpy(),
                                  np.asarray(jgrid.cell_coords(G)))
    w = tgrid.cells_to_world(coords, 0, SCALE, G).numpy()
    np.testing.assert_array_equal(
        w, np.asarray(jgrid.cells_to_world(jgrid.cell_coords(G), 0, SCALE,
                                           G)))
    s, half = 0.5, 0.5 / G
    assert w.min() == -(s - half) and w.max() == (s - half)


def _cameras(n=6, seed=0):
    rng = np.random.RandomState(seed)
    poses = []
    for _ in range(n):
        eye = rng.randn(3)
        eye = 1.3 * eye / np.linalg.norm(eye)
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        poses.append(np.stack([right, down, fwd, eye], 1))
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    return K, np.stack(poses).astype(np.float32)


@pytest.mark.parametrize("case", ["narrow", "orbit"])
def test_mark_invisible_cells_equals_jax(case):
    if case == "narrow":       # tests/test_grid.py's single narrow camera
        K = np.array([[300.0, 0, 32], [0, 300.0, 32], [0, 0, 1]], np.float32)
        poses = np.concatenate([np.eye(3), [[0], [0], [-2.0]]],
                               1)[None].astype(np.float32)
    else:
        K, poses = _cameras()
    kw = dict(img_w=64, img_h=64, grid_size=G, cascades=1, scale=SCALE)
    got = tgrid.mark_invisible_cells(K, poses, device="cpu", **kw).numpy()
    want = np.asarray(jgrid.mark_invisible_cells(K, poses, **kw))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > 0 and (got == -1).sum() > 0


def test_segment_max_dense_equals_jax():
    key = jax.random.PRNGKey(11)
    n, m = 257, 4096
    idx = np.array(jax.random.randint(key, (m,), 0, n, dtype=jnp.int32))
    vals = np.array(jnp.abs(jax.random.normal(jax.random.fold_in(key, 1),
                                              (m,))) * 50)
    got = tgrid._segment_max_dense(torch.as_tensor(idx),
                                   torch.as_tensor(vals), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(jgrid._segment_max_dense,
                                        static_argnums=2)(idx, vals, n)))


def test_erode_equals_jax():
    rng = np.random.RandomState(0)
    grid = np.where(rng.rand(1, 16, 16, 16) < 0.3,
                    rng.uniform(-1, 20, (1, 16, 16, 16)), 0.0)
    grid[0, 5, 5, 5] = 100.0
    grid = grid.astype(np.float32)
    got = tgrid._erode(torch.as_tensor(grid)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgrid._erode(grid)))
    assert got[0, 5, 5, 5]


def _update_both(grid0, key, warmup, **kw):
    kw = dict(scale=SCALE, density_threshold=0.6, warmup=warmup, **kw)
    jnew, jocc = jax.jit(lambda g, k: jgrid.update_density_grid(
        g, lambda x: _density(x, jnp), k, **kw))(jnp.asarray(grid0), key)
    new, occ = tgrid.update_density_grid(
        torch.tensor(grid0), lambda x: _density(x, torch),
        draws=jax_draws(key, warmup, kw.get("sample_div", 4)), **kw)
    return (new.numpy(), occ.numpy()), (np.asarray(jnew), np.asarray(jocc))


def _assert_update_equal(got, want, threshold=0.6):
    (new, occ), (jnew, jocc) = got, want
    np.testing.assert_allclose(new, jnew, rtol=1e-5, atol=0)
    pos = jnew > 0
    mean = jnew[pos].mean() if pos.any() else 0.0
    thr = min(mean, threshold)
    near = np.abs(jnew - thr) <= 1e-6 * thr
    np.testing.assert_array_equal(occ[~near], jocc[~near])


def test_update_density_grid_warmup_then_sampled_equal_jax():
    key = jax.random.PRNGKey(0)
    grid0 = np.zeros((1, G, G, G), np.float32)
    grid0[0, :2] = -1.0                        # invisible cells stay dead
    got, want = _update_both(grid0, key, True)
    _assert_update_equal(got, want)
    assert want[1].sum() > 100 and (got[0][0, :2] == -1).all()
    # a sampled update from JAX's warmed grid, on JAX's draws
    got2, want2 = _update_both(want[0], jax.random.PRNGKey(1), False,
                               sample_div=4)
    _assert_update_equal(got2, want2)
    assert (got2[0] != want[0]).any()


def test_update_density_grid_decay_and_erode_equal_jax():
    grid0 = np.zeros((1, G, G, G), np.float32)
    grid0[0, 5, 5, 5] = 100.0
    grid0[0, 20:23, 20:23, 20:23] = 10.0
    got, want = _update_both(grid0, jax.random.PRNGKey(2), True, erode=True)
    _assert_update_equal(got, want)
    np.testing.assert_allclose(got[0][0, 5, 5, 5], 100 * 0.95 * 0.95,
                               rtol=1e-6)
