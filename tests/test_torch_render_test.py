"""The test-time ops of the PyTorch port against JAX's on the same numpy
inputs (the cases of tests/test_march_composite.py): calc_dt,
occupancy_lookup, the dense training marcher, one test round of the
marcher, the per-round composite, and render_test on a small field.

Tolerances: step sizes rtol 1e-6; ts and xyzs 1e-6, valid masks, the
truncation flag and the sample count exact; the per-round composite
1e-6 (the same f32 sums in the same order); render_test's rgb, opacity
and depth atol 2e-3 (PERF.md's frame tolerance: the same samples,
summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core.rays import get_rays
from google_nerf_tpu.data.synthetic import SyntheticDataset
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp
from google_nerf_tpu.models.rendering import render_test as jrender_test
from google_nerf_tpu.ops import composite as jc
from google_nerf_tpu.ops import marching as jm
from google_nerf_tpu.ops.ray_aabb import ray_aabb_intersect
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.rendering import render_test
from google_nerf_tpu_torch.ops import composite as tc
from google_nerf_tpu_torch.ops import marching as tm

GRID, SCALE, MAX_SAMPLES = 32, 0.5, 128


def _occ_grid(rng):
    """A solid ball of radius 0.25 plus 5% noise (C=1)."""
    g = np.arange(GRID)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    centers = ((np.stack([x, y, z], -1) + 0.5) / GRID * 2 - 1) * SCALE
    occ = (np.linalg.norm(centers, axis=-1) < 0.25)
    occ |= rng.rand(GRID, GRID, GRID) < 0.05
    return occ[None]


def _rays(rng, R, spread=0.6):
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = -1.5
    o[:, :2] = (rng.rand(R, 2) - 0.5) * spread
    d = rng.randn(R, 3).astype(np.float32) * 0.05
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hits = np.asarray(ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                         jnp.zeros(3), SCALE * jnp.ones(3)))
    return o, d, hits


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("esf", [0.0, 1 / 256])
def test_calc_dt_matches_jax(esf):
    t = np.array([0.0, 0.3, 1.0, 2.5, 1e9], np.float32)
    want = np.asarray(jm.calc_dt(jnp.asarray(t), esf, 1024, 128, 0.5))
    got = tm.calc_dt(_t(t), esf, 1024, 128, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_occupancy_lookup_matches_jax():
    rng = np.random.RandomState(0)
    occ = _occ_grid(rng)
    pts = ((rng.rand(500, 3) * 2 - 1) * SCALE * 0.99).astype(np.float32)
    dt = np.full(500, 3 ** 0.5 / MAX_SAMPLES, np.float32)
    want = np.asarray(jm.occupancy_lookup(jnp.asarray(occ), jnp.asarray(pts),
                                          jnp.asarray(dt), 1, SCALE, GRID))
    got = tm.occupancy_lookup(_t(occ), _t(pts), _t(dt), 1, SCALE, GRID)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("esf,n", [(0.0, 16), (0.0, 64), (1 / 256, 64)])
def test_candidate_ts_matches_jax(esf, n):
    """The affine lattice bit for bit; the exponential walk (JAX's scan)
    within 1e-6."""
    rng = np.random.RandomState(5)
    t0 = rng.uniform(0.0, 2.0, 40).astype(np.float32)
    noise = rng.rand(40).astype(np.float32)
    wts, wdts = jm.candidate_ts(jnp.asarray(t0), n, esf, 1024, 128, 0.5,
                                noise=jnp.asarray(noise))
    ts, dts = tm.candidate_ts(_t(t0), n, esf, 1024, 128, 0.5,
                              noise=_t(noise))
    if esf == 0.0:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(wts))
        np.testing.assert_array_equal(dts.numpy(), np.asarray(wdts))
    else:
        np.testing.assert_allclose(ts.numpy(), np.asarray(wts), rtol=1e-6)
        np.testing.assert_allclose(dts.numpy(), np.asarray(wdts), rtol=1e-6)


@pytest.mark.parametrize("K", [16, 48])
def test_march_train_matches_jax(K):
    rng = np.random.RandomState(1)
    occ = _occ_grid(rng)
    o, d, hits = _rays(rng, 32)
    noise = rng.rand(32).astype(np.float32)
    kw = dict(cascades=1, scale=SCALE, exp_step_factor=0.0, grid_size=GRID,
              max_samples=MAX_SAMPLES, k_samples=K)
    want = jm.march_rays_train(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(hits), jnp.asarray(occ),
                               noise=jnp.asarray(noise), **kw)
    got = tm.march_rays_train(_t(o), _t(d), _t(hits), _t(occ),
                              noise=_t(noise), **kw)
    for k in ("valid", "truncated"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert int(got["total_samples"]) == int(want["total_samples"]) > 0
    for k in ("ts", "deltas", "xyzs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)


def test_march_test_round_matches_jax():
    """Rounds of the test marcher from per-ray resume points, as JAX
    walks them: each round's samples and t_next."""
    rng = np.random.RandomState(4)
    occ = _occ_grid(rng)
    o, d, hits = _rays(rng, 24, spread=0.5)
    kw = dict(cascades=1, scale=SCALE, exp_step_factor=0.0, grid_size=GRID,
              max_samples=MAX_SAMPLES, n_cand=32, k_samples=8)
    t_cur = np.maximum(hits[:, 0], 0.0)
    t2 = hits[:, 1]
    alive = hits[:, 0] >= 0
    alive[::5] = False
    for _ in range(6):
        want = jm.march_rays_test_round(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cur),
            jnp.asarray(t2), jnp.asarray(alive), jnp.asarray(occ), **kw)
        got = tm.march_rays_test_round(_t(o), _t(d), _t(t_cur), _t(t2),
                                       _t(alive), _t(occ), **kw)
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(want["valid"]))
        for k in ("ts", "deltas", "xyzs", "t_next"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-6)
        t_cur = np.asarray(want["t_next"])
        alive = alive & (t_cur < t2)


def test_composite_test_round_matches_jax():
    rng = np.random.RandomState(2)
    R, K = 16, 32
    sig = (rng.rand(R, K) * 30).astype(np.float32)
    rgb = rng.rand(R, K, 3).astype(np.float32)
    deltas = np.full((R, K), 0.01, np.float32)
    ts = np.cumsum(deltas, -1).astype(np.float32)
    valid = rng.rand(R, K) > 0.3
    T = rng.uniform(0.0, 1.0, R).astype(np.float32)
    acc = [rng.rand(R).astype(np.float32), rng.rand(R).astype(np.float32),
           rng.rand(R, 3).astype(np.float32)]
    want = jc.composite_rays_test_round(
        *(jnp.asarray(a) for a in (sig, rgb, deltas, ts, valid, T, *acc)),
        T_threshold=1e-4)
    got = tc.composite_rays_test_round(
        *(_t(a) for a in (sig, rgb, deltas, ts, valid, T, *acc)),
        T_threshold=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("chunk", [480, 200])
def test_render_test_matches_jax(chunk):
    """render_test on a random packed field (table x2e3) and 15%
    occupancy over a 24x20 view: one chunk, and chunks with padding."""
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=32,
                      packed_log2_size=12, packed_levels=4)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 2e3
    occ = jax.random.bernoulli(jax.random.PRNGKey(3), 0.15, (1, 32, 32, 32))
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(24, 20))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    kw = dict(T_threshold=1e-3, chunk=chunk, n_cand=32, k_samples=8,
              max_samples=256)
    want = jrender_test(params, jcfg, occ, o, d, **kw)
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                    packed_log2_size=12, packed_levels=4)
    got = render_test(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params), "cpu"), cfg, _t(occ), _t(o), _t(d), **kw)
    assert float(np.asarray(want["opacity"]).mean()) > 0.05
    for k in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3)
