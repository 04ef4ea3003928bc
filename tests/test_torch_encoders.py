"""The frequency and hash-grid encoders and the table gathers of the
PyTorch port against JAX (tests/test_model.py's encoder cases and
tests/test_compaction_gather.py's gather cases) on the same numpy inputs.

Tolerances: the frequency encoding atol 1e-5 for bands up to 2^11 pi
(sin/cos of arguments up to ~6.4e3 rad in two libms); the hash config
exact; table indices equal; the hash encode (bf16 rows, f32
interpolation) atol 1e-6 at tcnn's init and rtol 1e-5 at O(1) tables;
table gradients rtol 1e-5 atol 1e-6 (f32 sums of the same terms in
another order); dx rtol 1e-4 atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.models import encoders as je
from google_nerf_tpu.ops import table_gather as jtg
from google_nerf_tpu_torch.models import encoders as te
from google_nerf_tpu_torch.ops import table_gather as ttg

T = torch.as_tensor


def _table(cfg, seed=0, scale=1e4):
    """JAX's init (O(1) values after scale) as numpy."""
    return np.asarray(je.init_hashgrid(jax.random.PRNGKey(seed),
                                       cfg)) * np.float32(scale)


def _cfgs(**kw):
    return (je.hashgrid_config_for_scale(0.5, **kw),
            te.hashgrid_config_for_scale(0.5, **kw))


@pytest.mark.parametrize("n_freqs", [2, 12])
def test_frequency_encode_matches_jax_and_golden(n_freqs):
    x = np.random.RandomState(0).rand(200, 3).astype(np.float32)
    x[0] = [0.25, 0.0, 1.0]
    got = te.frequency_encode(T(x), n_freqs).numpy()
    assert got.shape == (200, 3 * 2 * n_freqs)
    np.testing.assert_allclose(
        got, np.asarray(je.frequency_encode(jnp.asarray(x), n_freqs)),
        atol=1e-5)
    # dim 0, the first two bands: sin(pi/4), sin(pi/2), then the cosines
    # (JAX's golden; higher bands carry f32 pi's error times 2^i)
    np.testing.assert_allclose(
        got[0, [0, 1, n_freqs, n_freqs + 1]],
        [np.sin(np.pi / 4), np.sin(np.pi / 2), np.cos(np.pi / 4),
         np.cos(np.pi / 2)], atol=1e-6)


def test_hashgrid_config_matches_reference_formula():
    jcfg, cfg = _cfgs(num_levels=16)
    np.testing.assert_allclose(cfg.per_level_scale, 64.0 ** (1 / 15),
                               rtol=1e-6)
    assert cfg == te.HashGridConfig(**vars(jcfg))
    assert cfg.resolutions == jcfg.resolutions
    assert cfg.resolutions[0] == 16 and cfg.resolutions[-1] in (1023, 1024)
    assert (cfg.table_size, cfg.out_dim) == (2 ** 19, 32)


@pytest.mark.parametrize("kw", [dict(num_levels=4, log2_hashmap_size=13),
                                dict(num_levels=16, log2_hashmap_size=14)])
def test_corner_indices_equal_jax(kw):
    """Dense (x-fastest) and hashed levels: every corner's index equal to
    JAX's, corners unclipped (c0 + 1 reaches the resolution)."""
    jcfg, cfg = _cfgs(**kw)
    L, Tn = cfg.n_levels, cfg.table_size
    res = np.asarray(cfg.resolutions)
    dense = np.array([(r + 1) ** 3 <= Tn for r in res])
    assert dense.any() and not dense.all()
    rng = np.random.RandomState(3)
    c = (rng.rand(L, 500, 3) * (res[:, None, None] + 1)).astype(np.int32)
    c[:, 0] = res[:, None]                              # the far corner
    got = te._corner_indices(T(c).long(), T(dense), T(res).long(), Tn)
    want = je._corner_indices(jnp.asarray(c), jnp.asarray(dense),
                              jnp.asarray(res, jnp.int32), Tn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_encode_interpolates():
    _, cfg = _cfgs(num_levels=4, log2_hashmap_size=10)
    table = te.init_hashgrid(torch.Generator().manual_seed(0), cfg, "cpu")
    assert table.shape == (4, 1024, 2) and float(table.abs().max()) <= 1e-4
    x = T(np.random.RandomState(1).rand(64, 3).astype(np.float32))
    table.requires_grad_(True)
    out = te.hash_encode(table, x, cfg)
    assert out.shape == (64, cfg.out_dim) and torch.isfinite(out).all()
    with torch.no_grad():
        out2 = te.hash_encode(table, x + 1e-5, cfg)
        assert float((out2 - out).abs().max()) < 1e-4
    out.sum().backward()
    assert float(table.grad.abs().sum()) > 0


def test_hash_encode_dense_levels_are_collision_free():
    jcfg, cfg = _cfgs(num_levels=2, log2_hashmap_size=19)
    table = np.array(je.init_hashgrid(jax.random.PRNGKey(0), jcfg))
    res = cfg.resolutions[0]
    coords = np.stack(np.meshgrid(*([np.arange(4)] * 3), indexing="ij"),
                      -1).reshape(-1, 3)
    x = (coords / res).astype(np.float32)               # exact vertices
    out = te.hash_encode(T(table), T(x), cfg).numpy()[:, :cfg.n_features]
    idx = coords[:, 0] + coords[:, 1] * (res + 1) + coords[:, 2] * (
        res + 1) ** 2
    np.testing.assert_allclose(out, table[0][idx], atol=1e-6)


def _f64_dtable(table, x, cot, cfg):
    """float64 sums of the table gradient's payloads w * g per (level,
    row), and the sums of their magnitudes."""
    L, Tn, F = table.shape
    res_i, res_f, dense, offs = te._consts(cfg, "cpu")
    pos = T(x)[None] * res_f[:, None, None]
    c0f = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0),
                        res_f[:, None, None] - 1)
    w = te._corner_weights(pos - c0f).double().numpy()        # (L, N, 8)
    c = c0f.long()[:, None] + offs[None, :, None]
    idx = te._corner_indices(c, dense, res_i, Tn).numpy()     # (L, 8, N)
    gl = cot.astype(np.float64).reshape(len(x), L, F).transpose(1, 0, 2)
    ref, mag = np.zeros(table.shape), np.zeros(table.shape)
    for l in range(L):
        for k in range(8):
            pay = w[l, :, k, None] * gl[l]
            np.add.at(ref[l], idx[l, k], pay)
            np.add.at(mag[l], idx[l, k], np.abs(pay))
    return ref, mag


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hash_encode_values_and_grads_match_jax(dtype):
    """The cotangent is scaled by 0.01, as in the packed encoder's test:
    JAX's per-row sums are differences of a running sum, whose rounding
    (~1e-7 of the running sum, on rows with no payload too) must stay
    under atol.  The port's dtable is also held to the float64 sums,
    within 1e-6 of each entry's sum of |payload|."""
    jcfg, cfg = _cfgs(num_levels=6, log2_hashmap_size=13,
                      table_dtype=dtype)
    table = _table(jcfg)
    rng = np.random.RandomState(4)
    x = rng.rand(300, 3).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1.0]]
    cot = (rng.randn(300, cfg.out_dim) * 0.01).astype(np.float32)

    def jloss(t, xx):
        return (je.hash_encode(t, xx, jcfg) * cot).sum()

    want = np.asarray(je.hash_encode(jnp.asarray(table), jnp.asarray(x),
                                     jcfg))
    jgt, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                               jnp.asarray(x))
    tt, tx = T(table).requires_grad_(True), T(x).requires_grad_(True)
    got = te.hash_encode(tt, tx, cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    (got * T(cot)).sum().backward()
    dt = tt.grad.numpy()
    assert np.abs(dt).sum() > 0
    np.testing.assert_allclose(dt, np.asarray(jgt), rtol=1e-5, atol=1e-7)
    ref, mag = _f64_dtable(table, x, cot, cfg)
    assert (np.abs(dt - ref) <= 1e-6 * mag).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(jgx)).max())


def test_hash_encode_bf16_gather_close_to_f32():
    """bf16 rows stay within quantization noise of f32 rows (values
    O(1)), as in JAX."""
    _, cfg32 = _cfgs(num_levels=4, log2_hashmap_size=10,
                     table_dtype="float32")
    _, cfg16 = _cfgs(num_levels=4, log2_hashmap_size=10)
    table = T(_table(cfg32))
    x = T(np.random.RandomState(7).rand(64, 3).astype(np.float32))
    a = te.hash_encode(table, x, cfg32)
    b = te.hash_encode(table, x, cfg16)
    assert float((a - b).abs().max()) < 1e-2
    assert float((a - b).abs().mean()) < 2e-3


def test_hash_encode_grads_match_a_per_corner_version():
    """The table gradient through batched_table_gather equals autograd of
    a per-corner restatement (8 plain takes per level), and both match
    central differences of the f32 encode."""
    _, cfg = _cfgs(num_levels=2, log2_hashmap_size=8, table_dtype="float32")
    table = T(_table(cfg)).requires_grad_(True)
    x = T(np.random.RandomState(3).rand(5, 3).astype(np.float32))

    def per_corner(t):
        res_i, res_f, dense, offs = te._consts(cfg, "cpu")
        pos = x[None] * res_f[:, None, None]
        c0f = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0),
                            res_f[:, None, None] - 1)
        frac = pos - c0f
        out = 0.0
        for c in range(8):
            cc = c0f.long() + offs[c]
            idx = te._corner_indices(cc, dense, res_i, cfg.table_size)
            w = torch.where(offs[c] == 1, frac, 1 - frac).prod(-1)
            rows = torch.stack([t[l][idx[l]] for l in range(2)])
            out = out + w[..., None] * rows
        return out.permute(1, 0, 2).reshape(5, -1)

    f = lambda t: (te.hash_encode(t, x, cfg) ** 2).sum()  # noqa: E731
    g, = torch.autograd.grad(f(table), table)
    g_ref, = torch.autograd.grad((per_corner(table) ** 2).sum(), table)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    touched = np.argwhere(g[0].abs().sum(-1).numpy() > 0)[:3, 0]
    eps = 1e-3
    with torch.no_grad():
        for i in touched:
            tp, tn = table.clone(), table.clone()
            tp[0, i, 0] += eps
            tn[0, i, 0] -= eps
            num = (f(tp) - f(tn)) / (2 * eps)
            np.testing.assert_allclose(float(g[0, i, 0]), float(num),
                                       rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("bwd_mode", ["sorted", "scatter"])
def test_table_gather_forward_and_backward_match_jax(bwd_mode):
    rng = np.random.RandomState(2)
    M, N, F = 64, 500, 2
    table = rng.randn(M, F).astype(np.float32)
    idx = rng.randint(0, M, N).astype(np.int32)
    cot = rng.randn(N, F).astype(np.float32)
    tt = T(table).requires_grad_(True)
    out = ttg.table_gather(tt, T(idx), bwd_mode)
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (out * T(cot)).sum().backward()
    want = jax.grad(lambda t: (jtg.table_gather(t, jnp.asarray(idx),
                                                bwd_mode) * cot).sum())(
        jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for pattern in (np.zeros(100, np.int32), np.arange(32, dtype=np.int32)):
        t0 = torch.zeros((32, F), requires_grad=True)
        ttg.table_gather(t0, T(pattern), bwd_mode).sum().backward()
        ref = np.zeros((32, F), np.float32)
        np.add.at(ref, pattern, 1.0)
        np.testing.assert_array_equal(t0.grad.numpy(), ref)


@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
def test_batched_table_gather_matches_jax(gather_dtype):
    """Values (bf16 rows cast to f32, as JAX's) equal JAX's; the table
    gradient equals JAX's sort-based one within f32 order, per level,
    with collisions, untouched rows and the extremes (one row; every row
    once)."""
    rng = np.random.RandomState(5)
    L, Tn, M, F = 3, 32, 200, 2
    table = rng.randn(L, Tn, F).astype(np.float32)
    idx = rng.randint(0, Tn, (L, M)).astype(np.int32)
    cot = rng.randn(L, M, F).astype(np.float32)
    tt = T(table).requires_grad_(True)
    out = ttg.batched_table_gather(tt, T(idx), gather_dtype)
    assert out.dtype == torch.float32
    want = jtg.batched_table_gather(jnp.asarray(table), jnp.asarray(idx),
                                    gather_dtype)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    (out * T(cot)).sum().backward()
    jg = jax.grad(lambda t: (jtg.batched_table_gather(
        t, jnp.asarray(idx), gather_dtype) * cot).sum())(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    for pattern in (np.zeros((L, M), np.int32),
                    np.broadcast_to(np.arange(Tn, dtype=np.int32), (L, Tn))):
        t0 = torch.zeros((L, Tn, F), requires_grad=True)
        ttg.batched_table_gather(t0, T(pattern.copy()),
                                 gather_dtype).sum().backward()
        ref = np.zeros((L, Tn, F), np.float32)
        for l in range(L):
            np.add.at(ref[l], pattern[l], 1.0)
        np.testing.assert_array_equal(t0.grad.numpy(), ref)


def test_gathers_refuse_an_unknown_backward():
    with pytest.raises(ValueError, match="bwd_mode"):
        ttg.table_gather(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32),
                         "segment")
