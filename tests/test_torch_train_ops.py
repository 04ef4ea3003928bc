"""The training ops of the PyTorch port against JAX on the same numpy
inputs: trunc_exp and its clamped gradient, the composite's gradients,
the packed encoder's custom gradient (dtable through P3's plain version,
dx), and the rays helpers.

Tolerances: trunc_exp rtol 1e-5 (values) and 1e-4 (gradient, as the JAX
test); composite gradients atol/rtol 1e-5 (f32 sums in another order);
the encoder's dtable and dx rtol 1e-5, atol 1e-7 (JAX sums a key's
payloads as a difference of a sorted cumsum, the port adds them per
row); on single-cell inputs, where JAX's sums are exact, dtable rtol
1e-6, which a bf16 round trip of the gradient misses by orders of
magnitude; axisangle_to_R 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core import rays as jrays
from google_nerf_tpu.ops import packed_hash as jph
from google_nerf_tpu.ops.composite import composite_rays_train as jcomposite
from google_nerf_tpu.ops.trunc_exp import trunc_exp as jtrunc_exp
from google_nerf_tpu_torch.core import rays as trays
from google_nerf_tpu_torch.ops import packed_hash as tph
from google_nerf_tpu_torch.ops.composite import composite_rays_train
from google_nerf_tpu_torch.ops.trunc_exp import trunc_exp

CFG = dict(n_levels=4, n_features=2, log2_table_size=12, base_resolution=16,
           per_level_scale=2.0)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def test_trunc_exp_forward_and_clamped_grad():
    x = np.array([-20.0, -15.5, 0.0, 2.0, 15.5, 20.0], np.float32)
    xt = _t(x, grad=True)
    y = trunc_exp(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jtrunc_exp(x)),
                               rtol=1e-5)
    y.sum().backward()
    jg = jax.grad(lambda v: jtrunc_exp(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.exp(np.clip(x, -15, 15)), rtol=1e-4)


def test_composite_rays_train_gradients_match_jax():
    rng = np.random.RandomState(0)
    R, K = 16, 24
    sig = np.abs(rng.randn(R, K)).astype(np.float32) * 30
    rgb = rng.uniform(0, 1, (R, K, 3)).astype(np.float32)
    dt = np.full((R, K), 0.01, np.float32)
    ts = np.sort(rng.uniform(0.1, 1.5, (R, K)), -1).astype(np.float32)
    valid = rng.rand(R, K) > 0.3
    gt = rng.uniform(0, 1, (R, 3)).astype(np.float32)

    def jloss(s, c):
        out = jcomposite(s, c, dt, ts, valid, 1e-4)
        return (jnp.mean((out["rgb"] - gt) ** 2) + out["opacity"].mean()
                + 0.1 * out["depth"].mean())

    js, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sig),
                                              jnp.asarray(rgb))
    s, c = _t(sig, True), _t(rgb, True)
    out = composite_rays_train(s, c, _t(dt), _t(ts), _t(valid), 1e-4)
    ((out["rgb"] - _t(gt)) ** 2).mean().add(out["opacity"].mean()).add(
        0.1 * out["depth"].mean()).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def _encode_grads(table, x, g, dtype):
    """(dtable, dx) of <encode(table, x), g> on both sides."""
    jcfg = jph.PackedHashConfig(table_dtype=dtype, **CFG)
    cfg = tph.PackedHashConfig(table_dtype=dtype, **CFG)
    jdt, jdx = jax.grad(lambda t, xx: jnp.vdot(
        jph.packed_hash_encode(t, xx, jcfg), g), argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    tt, xt = _t(table, True), _t(x, True)
    (tph.packed_hash_encode(tt, xt, cfg) * _t(g)).sum().backward()
    return (tt.grad.numpy(), xt.grad.numpy()), (np.asarray(jdt),
                                                np.asarray(jdx))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encoder_gradients_match_jax_custom_vjp(dtype):
    """g is scaled by 0.01, as in tests/test_packed_hash.py's precision
    test: JAX's per-row sums are differences of a running sum, whose
    rounding (~1e-7 of the running sum, on rows with no payload too) must
    stay under atol.  The port's dtable is also held to the float64 sums,
    within 1e-6 of each entry's sum of |payload| (f32 sums of mixed
    signs)."""
    rng = np.random.RandomState(1)
    table = (rng.uniform(-1, 1, (4, 4096, 16)) * 0.1).astype(np.float32)
    x = rng.uniform(0.01, 0.99, (300, 3)).astype(np.float32)
    g = (rng.randn(300, 8) * 0.01).astype(np.float32)
    (dt, dx), (jdt, jdx) = _encode_grads(table, x, g, dtype)
    assert np.abs(dt).sum() > 0
    np.testing.assert_allclose(dt, jdt, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-7)
    cfg = tph.PackedHashConfig(table_dtype=dtype, **CFG)
    keys, frac = tph._cell_keys(_t(x), cfg)
    w = tph._corner_weights(frac).double().numpy()
    gl = g.astype(np.float64).reshape(300, 4, 2).transpose(1, 0, 2)
    ref, mag = np.zeros(table.shape), np.zeros(table.shape)
    for l in range(4):
        pay = (w[l][:, :, None] * gl[l][:, None, :]).reshape(300, 16)
        np.add.at(ref[l], keys[l].numpy(), pay)
        np.add.at(mag[l], keys[l].numpy(), np.abs(pay))
    assert (np.abs(dt - ref) <= 1e-6 * mag).all()


def _bf16_autograd_dtable(table, x, g):
    """dtable by plain autograd through the forward's bf16 cast: the
    gradient rounded to bf16 and summed in bf16, the trap the port's
    custom backward avoids."""
    cfg = tph.PackedHashConfig(table_dtype="bfloat16", **CFG)
    tt = _t(table, True)
    keys, frac = tph._cell_keys(_t(x), cfg)
    rows = torch.stack([tt[l].to(torch.bfloat16)[keys[l]]
                        for l in range(tt.shape[0])]).float()
    rows = rows.reshape(tt.shape[0], x.shape[0], 8, 2)
    feat = (tph._corner_weights(frac)[..., None] * rows).sum(-2)
    (feat.permute(1, 0, 2).reshape(x.shape[0], -1) * _t(g)).sum().backward()
    return tt.grad.numpy()


def test_table_gradient_has_no_bf16_round_trip():
    """64 samples in one cell per level (JAX's sorted sums are then plain
    in-order sums): dtable agrees with JAX at rtol 1e-6; autograd through
    the bf16 cast would be off by ~1e-3."""
    rng = np.random.RandomState(2)
    table = (rng.uniform(-1, 1, (4, 4096, 16)) * 0.1).astype(np.float32)
    x = np.tile(np.array([[0.3137, 0.5921, 0.1234]], np.float32), (64, 1))
    g = (1.0 + rng.uniform(0, 1, (64, 8))).astype(np.float32)
    (dt, _), (jdt, _) = _encode_grads(table, x, g, "bfloat16")
    nz = np.abs(jdt) > 0
    assert nz.sum() == 4 * 16
    np.testing.assert_allclose(dt, jdt, rtol=1e-6, atol=0)
    bad = _bf16_autograd_dtable(table, x, g)
    assert not np.allclose(bad, jdt, rtol=1e-6, atol=0)
    assert np.abs(bad - jdt)[nz].max() / np.abs(jdt[nz]).max() > 1e-4


def test_axisangle_to_R_matches_jax():
    rng = np.random.RandomState(3)
    v = np.concatenate([[[0, 0, 0], [0, 0, np.pi / 2]],
                        rng.randn(30, 3) * 0.7]).astype(np.float32)
    got = trays.axisangle_to_R(_t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrays.axisangle_to_R(v)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[0], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(got[1], [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                               atol=1e-6)
    np.testing.assert_allclose(got[1] @ got[1].T, np.eye(3), atol=1e-6)


def test_pose_helpers_match_jax():
    rng = np.random.RandomState(4)
    poses = np.tile(np.eye(4)[:3], (4, 1, 1)).astype(np.float64)
    poses[:, :, 3] = rng.randn(4, 3) + 5.0
    pts = rng.randn(50, 3) + 5.0
    for a, b in zip(trays.center_poses(poses, pts),
                    jrays.center_poses(poses, pts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trays.average_poses(poses, pts),
                                  jrays.average_poses(poses, pts))
    np.testing.assert_array_equal(trays.create_spheric_poses(4.0, 1.0, 10),
                                  jrays.create_spheric_poses(4.0, 1.0, 10))
