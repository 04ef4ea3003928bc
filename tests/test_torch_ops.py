"""Small ops of the PyTorch port against their JAX counterparts on the
same numpy inputs: camera rays, ray/AABB, SH, the bias-free MLP,
trunc_exp, compositing and PSNR.  fp32 paths agree to 1e-5 (summation
order only); the bf16 MLP to the bf16 operand rounding, 2e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core import rays as jr
from google_nerf_tpu.eval.metrics import psnr as jax_psnr
from google_nerf_tpu.models.encoders import sh_encode_deg4 as jax_sh
from google_nerf_tpu.models.mlp import mlp_apply as jax_mlp
from google_nerf_tpu.ops.composite import composite_rays_train as jax_comp
from google_nerf_tpu.ops.ray_aabb import clamp_near as jax_clamp_near
from google_nerf_tpu.ops.ray_aabb import ray_aabb_intersect as jax_aabb
from google_nerf_tpu.ops.trunc_exp import trunc_exp as jax_trunc_exp
from google_nerf_tpu_torch.core import rays as tr
from google_nerf_tpu_torch.eval.metrics import psnr
from google_nerf_tpu_torch.models.encoders import sh_encode_deg4
from google_nerf_tpu_torch.models.mlp import init_mlp, mlp_apply
from google_nerf_tpu_torch.ops.composite import composite_rays_train
from google_nerf_tpu_torch.ops.ray_aabb import clamp_near, ray_aabb_intersect
from google_nerf_tpu_torch.ops.trunc_exp import trunc_exp

T = torch.as_tensor


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("convention", ["rdf", "rub"])
def test_ray_directions_match_jax(convention):
    K = np.array([[100.0, 0, 4.0], [0, 90.0, 3.0], [0, 0, 1]], np.float32)
    d, uv = tr.get_ray_directions(6, 8, K, convention=convention,
                                  return_uv=True, device="cpu")
    jd, juv = jr.get_ray_directions(6, 8, K, convention=convention,
                                    return_uv=True)
    _close(d, jd, atol=0, rtol=0)
    _close(uv, juv, atol=0, rtol=0)
    assert tr.get_ray_directions(6, 8, K, flatten=False,
                                 device="cpu").shape == (6, 8, 3)
    with pytest.raises(ValueError):
        tr.get_ray_directions(6, 8, K, convention="xyz", device="cpu")


@pytest.mark.parametrize("batched", [False, True])
def test_get_rays_match_jax(batched):
    rng = np.random.RandomState(0)
    dirs = rng.randn(5, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    c2w = np.concatenate([q, rng.randn(3, 1)], 1).astype(np.float32)
    if batched:
        c2w = np.broadcast_to(c2w, (5, 3, 4)).copy()
    o, d = tr.get_rays(T(dirs), T(c2w))
    jo, jd = jr.get_rays(jnp.asarray(dirs), jnp.asarray(c2w))
    _close(o, jo)
    _close(d, jd)


def test_ray_aabb_and_clamp_near_match_jax():
    rng = np.random.RandomState(1)
    o = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    d = rng.randn(200, 3).astype(np.float32)
    d[:5, 0] = 0.0                     # axis-parallel rays hit the 1e-10 guard
    got = clamp_near(ray_aabb_intersect(T(o), T(d), np.zeros(3),
                                        np.full(3, 0.5)), 0.05)
    want = jax_clamp_near(jax_aabb(jnp.asarray(o), jnp.asarray(d),
                                   jnp.zeros(3), jnp.full((3,), 0.5)), 0.05)
    _close(got, want)
    assert (got[:, 0] == -1).any() and (got[:, 0] >= 0.05).any()


def test_sh_and_trunc_exp_match_jax():
    rng = np.random.RandomState(2)
    d = rng.randn(100, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(sh_encode_deg4(T(d)), jax_sh(jnp.asarray(d)))
    x = rng.uniform(-20, 20, 100).astype(np.float32)
    _close(trunc_exp(T(x)), jax_trunc_exp(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_mlp_apply_matches_jax(dtype, atol):
    """bf16: operands rounded to bf16, f32 accumulation and an f32 (not
    re-rounded) output, like jnp.dot(preferred_element_type=f32)."""
    rng = np.random.RandomState(3)
    ws = [rng.uniform(-1, 1, (a, b)).astype(np.float32) * (6 / a) ** 0.5
          for a, b in ((32, 64), (64, 64), (64, 3))]
    x = rng.randn(300, 32).astype(np.float32)
    got = mlp_apply([T(w) for w in ws], T(x),
                    compute_dtype=getattr(torch, dtype))
    want = jax_mlp([jnp.asarray(w) for w in ws], jnp.asarray(x),
                   compute_dtype=getattr(jnp, dtype))
    assert got.dtype == torch.float32
    _close(got, want, atol=atol, rtol=0)


def test_init_mlp_is_seeded_kaiming_uniform():
    ws = init_mlp(torch.Generator().manual_seed(0), [32, 64, 3],
                  device="cpu")
    again = init_mlp(torch.Generator().manual_seed(0), [32, 64, 3],
                     device="cpu")
    assert [tuple(w.shape) for w in ws] == [(32, 64), (64, 3)]
    for w, w2, din in zip(ws, again, (32, 64)):
        assert torch.equal(w, w2)
        assert float(w.abs().max()) <= (6 / din) ** 0.5


def test_composite_and_psnr_match_jax():
    rng = np.random.RandomState(4)
    R, K = 50, 24
    sig = rng.uniform(0, 30, (R, K)).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, K, 3)).astype(np.float32)
    deltas = rng.uniform(0, 0.05, (R, K)).astype(np.float32)
    ts = np.cumsum(deltas, -1).astype(np.float32)
    valid = rng.uniform(size=(R, K)) > 0.2
    got = composite_rays_train(T(sig), T(rgb), T(deltas), T(ts), T(valid))
    want = jax_comp(*(jnp.asarray(a) for a in (sig, rgb, deltas, ts, valid)))
    for k in ("opacity", "depth", "depth_sq", "rgb", "ws"):
        _close(got[k], want[k])
    a, b = rng.uniform(size=(2, 16, 3)).astype(np.float32)
    _close(psnr(T(a), T(b)), jax_psnr(jnp.asarray(a), jnp.asarray(b)))
