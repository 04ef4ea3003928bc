"""Packed-corner hash encoder and the packed NGP field of the PyTorch port
against JAX, with JAX params carried across by params_from_jax.  Cell
keys (dense and hashed levels) must be equal; the encode agrees to 1e-5
(both gather bf16 rows, interpolate in f32); the field to 1e-4 in f32
compute and 3e-2 in bf16 compute (bf16 operand rounding can flip)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp as jax_init_ngp
from google_nerf_tpu.models.ngp import ngp_apply as jax_ngp_apply
from google_nerf_tpu.models.ngp import ngp_density as jax_ngp_density
from google_nerf_tpu.ops import packed_hash as jph
from google_nerf_tpu_torch.convert import load_bench_state, params_from_jax
from google_nerf_tpu_torch.models.ngp import (NGPConfig, init_ngp,
                                              ngp_apply, ngp_density)
from google_nerf_tpu_torch.ops import packed_hash as tph

SMALL = dict(packed_levels=4, packed_log2_size=12)
FLAGSHIP = dict(packed_levels=8, packed_log2_size=16, packed_features=2)


def _configs(widths, dtype):
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=16,
                      compute_dtype=getattr(jnp, dtype), **widths)
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=16,
                    compute_dtype=getattr(torch, dtype), **widths)
    return jcfg, cfg


def _params(jcfg):
    p = jax_init_ngp(jax.random.PRNGKey(0), jcfg)
    p["packed_table"] = p["packed_table"] * 1e3
    return p, params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.mark.parametrize("widths", [SMALL, FLAGSHIP])
def test_cell_keys_equal_jax(widths):
    jcfg, cfg = _configs(widths, "float32")
    assert cfg.packed_cfg == tph.PackedHashConfig(**vars(jcfg.packed_cfg))
    # dense and hashed levels must both be present in the config
    res = cfg.packed_cfg.resolutions
    assert res[0] ** 3 <= cfg.packed_cfg.table_size < res[-1] ** 3
    x = np.random.RandomState(0).uniform(0, 1, (400, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1]]
    keys, frac = tph._cell_keys(torch.as_tensor(x), cfg.packed_cfg)
    jkeys, jfrac = jph._cell_keys(jnp.asarray(x), jcfg.packed_cfg)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_allclose(frac.numpy(), np.asarray(jfrac), atol=1e-6)
    w = tph._corner_weights(frac)
    np.testing.assert_allclose(w.numpy(), np.asarray(
        jph._corner_weights(jfrac)), atol=1e-7)


@pytest.mark.parametrize("widths", [SMALL, FLAGSHIP])
def test_encode_matches_jax(widths):
    jcfg, cfg = _configs(widths, "float32")
    jp, p = _params(jcfg)
    x = np.random.RandomState(1).uniform(0, 1, (300, 3)).astype(np.float32)
    got = tph.packed_hash_encode(p["packed_table"], torch.as_tensor(x),
                                 cfg.packed_cfg)
    want = jph.packed_hash_encode(jp["packed_table"], jnp.asarray(x),
                                  jcfg.packed_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("widths,dtype,atol", [
    (SMALL, "float32", 1e-4), (FLAGSHIP, "float32", 1e-4),
    (FLAGSHIP, "bfloat16", 3e-2)])
def test_ngp_density_and_apply_match_jax(widths, dtype, atol):
    jcfg, cfg = _configs(widths, dtype)
    jp, p = _params(jcfg)
    rng = np.random.RandomState(2)
    x = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    d = rng.randn(300, 3).astype(np.float32)
    sig, h = ngp_density(p, cfg, torch.as_tensor(x), return_feat=True)
    jsig, jh = jax_ngp_density(jp, jcfg, jnp.asarray(x), return_feat=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=atol,
                               rtol=atol)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=atol)
    sig2, rgb = ngp_apply(p, cfg, torch.as_tensor(x), torch.as_tensor(d))
    jsig2, jrgb = jax_ngp_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(sig2.numpy(), np.asarray(jsig2), rtol=atol)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=atol)


# encoder -> (table key, table shape, sigma MLP input) at SMALL widths
# with 4 hash levels of 2^12 rows and 12 frequency bands
INIT_SHAPES = {
    "packed": ("packed_table", (4, 4096, 16), 8),
    "packed2": ("pair_table", (2, 4096, 70), 8),
    "hash": ("hash_table", (4, 4096, 2), 8),
    "freq": (None, None, 72),
}


@pytest.mark.parametrize("encoder", list(INIT_SHAPES))
def test_init_ngp_shapes_and_unported_encoders(encoder):
    """Every xyz encoder of NGPConfig initialises (none is left
    unported): its table, U[-1e-4, 1e-4] (none for freq), and the MLPs'
    shapes; the keys and shapes equal JAX's init_ngp's."""
    key, shape, din = INIT_SHAPES[encoder]
    kw = dict(SMALL, encoder=encoder, num_levels=4, log2_hashmap_size=12)
    cfg = NGPConfig(**kw)
    p = init_ngp(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert cfg.xyz_feat_dim == din
    if key is not None:
        assert p[key].shape == shape
        assert 0 < float(p[key].abs().max()) <= 1e-4
    assert sorted(p) == sorted(k for k in (key, "sigma_mlp", "rgb_mlp")
                               if k)
    assert [tuple(w.shape) for w in p["sigma_mlp"]] == [(din, 64), (64, 16)]
    assert [tuple(w.shape) for w in p["rgb_mlp"]] == [(32, 64), (64, 64),
                                                      (64, 3)]
    jp = jax_init_ngp(jax.random.PRNGKey(0), JNGPConfig(**kw))
    assert {k: jax.tree_util.tree_map(np.shape, v) for k, v in jp.items()} \
        == {k: ([tuple(w.shape) for w in v] if isinstance(v, list)
                else tuple(v.shape)) for k, v in p.items()}


@pytest.mark.parametrize("refine_poses", [False, True])
def test_load_bench_state_leaf_order(tmp_path, refine_poses):
    """The bench.py npz (flat jax.tree_util leaves p0..pN + occ) loads
    into the port's params in the documented leaf order."""
    jcfg, cfg = _configs(SMALL, "float32")
    jp, _ = _params(jcfg)
    if refine_poses:
        jp["dR"], jp["dT"] = jnp.ones((3, 3)), jnp.full((3, 3), 2.0)
    flat, _ = jax.tree_util.tree_flatten(jp)
    occ = np.zeros((1, 16, 16, 16), bool)
    occ[0, 3, 4, 5] = True
    path = tmp_path / "state.npz"
    np.savez(path, occ=occ, **{f"p{i}": np.asarray(l, np.float32)
                               for i, l in enumerate(flat)})
    p, occ_t = load_bench_state(path, cfg, device="cpu")
    assert torch.equal(occ_t, torch.as_tensor(occ))
    want = jax.tree_util.tree_map(np.asarray, jp)
    assert sorted(p) == sorted(want)
    for k in want:
        for a, b in zip(p[k] if isinstance(p[k], list) else [p[k]],
                        want[k] if isinstance(want[k], list) else [want[k]]):
            np.testing.assert_array_equal(a.numpy(), b)
