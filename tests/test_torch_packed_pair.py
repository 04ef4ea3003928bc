"""The paired-level packed encoder (`packed2`) of the PyTorch port against
JAX (tests/test_packed_pair.py's 7 cases) on the same numpy inputs, with
JAX's table carried across.

Tolerances: the forward against JAX and against the plain restatement
rtol 1e-5, atol 1e-6 (the same f32 interpolation; bf16 rows where the
config gathers bf16); dtable against JAX rtol 1e-5, atol 1e-7 at a
cotangent of O(0.01) (JAX's cumsum-difference rows carry ~1e-7 of their
running sum) and within 1e-6 of each entry's sum of |payload| against
the float64 sums; against autodiff of the restatement rtol 1e-4, atol
5e-5 (JAX's); dx against JAX rtol 1e-4, against autodiff rtol 2e-3,
atol 1e-4 (JAX's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp as jax_init_ngp
from google_nerf_tpu.models.ngp import ngp_apply as jax_ngp_apply
from google_nerf_tpu.ops import packed_pair as jpp
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp, ngp_apply
from google_nerf_tpu_torch.ops import packed_pair as tpp

T = torch.as_tensor
KW = dict(n_pairs=3, n_features=2, log2_table_size=10, base_resolution=4,
          per_pair_scale=3.0)
CFG = tpp.PackedPairConfig(table_dtype="float32", **KW)
JCFG = jpp.PackedPairConfig(table_dtype="float32", **KW)


def _data(n=257, seed=0):
    """JAX's table (x1e4: O(1) values) and x, as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    table = np.asarray(jpp.init_packed_pair(k1, JCFG)) * np.float32(1e4)
    return table, np.array(jax.random.uniform(k2, (n, 3)))


def test_config_geometry():
    cfg = tpp.packed_pair_config_for_scale(0.5, n_pairs=4)
    assert cfg == tpp.PackedPairConfig(**vars(
        jpp.packed_pair_config_for_scale(0.5, n_pairs=4)))
    assert cfg.resolutions[0] == 16
    assert abs(cfg.child_resolutions[-1] - 1024) <= 2
    assert cfg.all_resolutions == tuple(
        v for r in cfg.resolutions for v in (r, 2 * r))
    assert (cfg.out_dim, cfg.row_width) == (16, 70)
    t = tpp.init_packed_pair(torch.Generator().manual_seed(0), CFG, "cpu")
    assert t.shape == (3, 1024, 70) and float(t.abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_and_reference(dtype):
    table, x = _data()
    cfg = tpp.PackedPairConfig(table_dtype=dtype, **KW)
    jcfg = jpp.PackedPairConfig(table_dtype=dtype, **KW)
    out = tpp.packed_pair_encode(T(table), T(x), cfg)
    assert out.shape == (x.shape[0], cfg.out_dim)
    want = jpp.packed_pair_encode(jnp.asarray(table), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if dtype == "float32":
        ref = tpp.packed_pair_encode_ref(T(table), T(x), cfg)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_padded_rows_are_16_byte_words():
    """P2 takes rows of a multiple of 16 bytes: the bf16 copy of a 70-wide
    row is padded to 72 (144 bytes), the f32 copy to 72 (288 bytes); the
    pad is zero and the rows are the table's."""
    table, _ = _data()
    for dtype in (torch.bfloat16, torch.float32):
        tab = tpp._padded_rows(T(table), dtype)
        assert tab.shape == (3 * 1024, 72) and tab.is_contiguous()
        assert (tab[:, 70:] == 0).all()
        assert torch.equal(tab[:, :70], T(table).to(dtype).reshape(-1, 70))


def test_boundary_positions_finite():
    table, _ = _data()
    x = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5],
                  [1.0, 0.0, 0.5]], np.float32)
    out = tpp.packed_pair_encode(T(table), T(x), CFG)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        out.numpy(), tpp.packed_pair_encode_ref(T(table), T(x), CFG).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jpp.packed_pair_encode(jnp.asarray(table), jnp.asarray(x), JCFG)),
        rtol=1e-5, atol=1e-6)


def _f64_dtable(x, cot):
    keys, fp, ci, ff, w8, w27 = tpp._pair_geometry(T(x), CFG)
    P, F = CFG.n_pairs, CFG.n_features
    g = cot.astype(np.float64).reshape(len(x), P, 2, F)
    ref = np.zeros((P, CFG.table_size, CFG.row_width))
    mag = np.zeros_like(ref)
    for p in range(P):
        pay = np.concatenate([
            (w8[p].double().numpy()[:, :, None] * g[:, p, 0, None, :])
            .reshape(len(x), -1),
            (w27[p].double().numpy()[:, :, None] * g[:, p, 1, None, :])
            .reshape(len(x), -1)], -1)
        np.add.at(ref[p], keys[p].numpy(), pay)
        np.add.at(mag[p], keys[p].numpy(), np.abs(pay))
    return ref, mag


def test_table_gradient_matches_jax_and_autodiff():
    table, x = _data(101)
    cot = (np.random.RandomState(1).randn(101, CFG.out_dim)
           * 0.01).astype(np.float32)
    tt = T(table).requires_grad_(True)
    (tpp.packed_pair_encode(tt, T(x), CFG) * T(cot)).sum().backward()
    jg = jax.grad(lambda t: jnp.vdot(jpp.packed_pair_encode(
        t, jnp.asarray(x), JCFG), cot))(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    ref, mag = _f64_dtable(x, cot)
    assert (np.abs(tt.grad.numpy() - ref) <= 1e-6 * mag).all()

    # JAX's case: sin(y) weighted by the column index, against autodiff
    # of the plain restatement
    def loss(fn, t):
        y = fn(t, T(x), CFG)
        return (torch.sin(y) * torch.arange(y.shape[1])).sum()
    g_vjp, = torch.autograd.grad(loss(tpp.packed_pair_encode, tt), tt)
    g_ref, = torch.autograd.grad(loss(tpp.packed_pair_encode_ref, tt), tt)
    np.testing.assert_allclose(g_vjp.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=5e-5)


def test_x_gradient_matches_jax_and_autodiff():
    table, x = _data(67)
    x = np.clip(x, 0.01, 0.99)      # off the cell faces, where it kinks
    tx = T(x).requires_grad_(True)
    (tpp.packed_pair_encode(T(table), tx, CFG) ** 2).sum().backward()
    jg = jax.grad(lambda xx: jnp.sum(jpp.packed_pair_encode(
        jnp.asarray(table), xx, JCFG) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())
    xr = T(x).requires_grad_(True)
    (tpp.packed_pair_encode_ref(T(table), xr, CFG) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), xr.grad.numpy(), rtol=2e-3,
                               atol=1e-4)


def test_child_c0_inside_parent_cell():
    """The child level is continuous across a child-cell face inside a
    parent cell (the 27-vertex grid is shared)."""
    table, _ = _data()
    eps = 1e-5
    a = T([[1.0 / 8 - eps, 0.1, 0.1]])
    b = T([[1.0 / 8 + eps, 0.1, 0.1]])
    F = CFG.n_features
    ya = tpp.packed_pair_encode(T(table), a, CFG)
    yb = tpp.packed_pair_encode(T(table), b, CFG)
    np.testing.assert_allclose(ya[0, F:2 * F].numpy(),
                               yb[0, F:2 * F].numpy(), atol=1e-3)


def test_ngp_integration_packed2():
    """The packed2 NGP field with JAX's params carried across: sigma and
    rgb equal JAX's (f32 compute, 1e-4), and the gradient reaches the
    pair table."""
    jcfg = JNGPConfig(scale=0.5, encoder="packed2", packed_log2_size=10)
    cfg = NGPConfig(scale=0.5, encoder="packed2", packed_log2_size=10)
    assert cfg.pair_cfg == tpp.PackedPairConfig(**vars(jcfg.pair_cfg))
    jp = jax_init_ngp(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert sorted(p) == ["pair_table", "rgb_mlp", "sigma_mlp"]
    rng = np.random.RandomState(2)
    x = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d = rng.randn(64, 3).astype(np.float32)
    p["pair_table"].requires_grad_(True)
    sig, rgb = ngp_apply(p, cfg, T(x), T(d))
    jsig, jrgb = jax_ngp_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(jsig),
                               rtol=1e-4)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb),
                               atol=1e-4)
    (sig.mean() + rgb.mean()).backward()
    assert float(p["pair_table"].grad.abs().sum()) > 0
    q = init_ngp(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert q["pair_table"].shape == (4, 1024, 70)


@pytest.mark.parametrize("n", [1, 8, 300])
def test_shapes(n):
    table, _ = _data()
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(3))
    assert tpp.packed_pair_encode(T(table), x, CFG).shape == (n, CFG.out_dim)
