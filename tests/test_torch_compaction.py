"""Sample compaction and the stream composite of the PyTorch port against
JAX (tests/test_compaction_gather.py:10-99, tests/test_stream_composite.py)
on the same numpy inputs.

Plan fields equal; pack/unpack values and gradients equal (they are
gathers); the stream composite's values and gradients within atol 1e-5
of JAX's (f32 sums in another order: JAX scans each ray's optical depth
as a tree, the port sums it along the ray's row)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops import compaction as jc
from google_nerf_tpu.ops.composite import composite_rays_train as jcomp
from google_nerf_tpu.ops.stream_composite import \
    composite_stream_train as jstream
from google_nerf_tpu_torch.ops import compaction as tc
from google_nerf_tpu_torch.ops.stream_composite import composite_stream_train
from google_nerf_tpu_torch.train.losses import NeRFLoss

KEYS = ("opacity", "depth", "depth_sq", "rgb", "tau", "t_last")


def _plan_cases():
    rng = np.random.RandomState(11)
    cases = [rng.rand(13, 17) < p for p in (0.0, 0.3, 1.0)]
    v = rng.rand(13, 17) < 0.4
    v[3] = False
    v[7] = True
    return cases + [v]


@pytest.mark.parametrize("sample_major", [True, False])
def test_plan_fields_equal_jax(sample_major):
    for v in _plan_cases():
        n_valid = int(v.sum())
        for budget in (1, 8, n_valid or 1, v.size, 2 * v.size):
            want = jax.jit(jc.plan_packing, static_argnums=(1, 2))(
                jnp.asarray(v), budget, sample_major)
            got = tc.plan_packing(torch.as_tensor(v), budget,
                                  sample_major=sample_major)
            for f in tc.PackPlan._fields:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                    err_msg=f"{f} budget {budget}")


@pytest.mark.parametrize("sample_major", [True, False])
def test_pack_unpack_values_and_gradients_equal_jax(sample_major):
    rng = np.random.RandomState(1)
    R, K, B = 6, 10, 40
    valid = rng.rand(R, K) > 0.4
    x = rng.randn(R * K, 3).astype(np.float32)
    w = rng.randn(3).astype(np.float32)
    gy = rng.randn(R * K).astype(np.float32)
    jplan = jc.plan_packing(jnp.asarray(valid), B, sample_major=sample_major)
    plan = tc.plan_packing(torch.as_tensor(valid), B,
                           sample_major=sample_major)

    def jf(x, w):
        return jnp.vdot(jc.unpack(jc.pack(x, jplan) @ w[:, None], jplan)
                        .reshape(-1), gy)

    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    packed = tc.pack(xt, plan)
    np.testing.assert_array_equal(packed.detach().numpy(),
                                  np.asarray(jc.pack(jnp.asarray(x), jplan)))
    un = tc.unpack(packed, plan)
    np.testing.assert_array_equal(
        un.detach().numpy(),
        np.asarray(jc.unpack(jc.pack(jnp.asarray(x), jplan), jplan)))
    (tc.unpack(packed @ wt[:, None], plan).reshape(-1)
     * torch.as_tensor(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)


def _fixture(seed, R=64, K=16, prefix=True):
    rng = np.random.RandomState(seed)
    if prefix:
        count = rng.randint(0, K + 1, R)
        valid = np.arange(K)[None] < count[:, None]
    else:
        valid = rng.rand(R, K) < 0.4
    sig = (np.abs(rng.randn(R, K)) * 20).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, K, 3)).astype(np.float32)
    ts = (np.sort(rng.uniform(0, 1, (R, K)), -1) + 0.1).astype(np.float32)
    dt = np.full((R, K), 0.01, np.float32)
    return valid, sig, rgb, dt, ts


def _stream_both(valid, sig, rgb, dt, ts, budget, grad_rays=None):
    """Stream composite on both sides; with grad_rays, also d(sum of rgb
    and opacity over those rays)/d(sig, rgb)."""
    R, K = valid.shape
    jplan = jc.plan_packing(jnp.asarray(valid), budget, sample_major=False)
    plan = tc.plan_packing(torch.as_tensor(valid), budget, sample_major=False)

    @jax.jit
    def jout(s, c):
        return jstream(jplan, jc.pack(s.reshape(-1), jplan),
                       jc.pack(c.reshape(-1, 3), jplan),
                       jc.pack(jnp.asarray(dt).reshape(-1), jplan),
                       jc.pack(jnp.asarray(ts).reshape(-1), jplan), R, K,
                       1e-4)

    st = torch.tensor(sig, requires_grad=True)
    ct = torch.tensor(rgb, requires_grad=True)
    got = composite_stream_train(
        plan, tc.pack(st.reshape(-1), plan), tc.pack(ct.reshape(-1, 3), plan),
        tc.pack(torch.as_tensor(dt).reshape(-1), plan),
        tc.pack(torch.as_tensor(ts).reshape(-1), plan), R, K, 1e-4)
    want = jout(jnp.asarray(sig), jnp.asarray(rgb))
    ray_mask = ~(valid & ~plan.keep.reshape(R, K).numpy()).any(-1)
    grads = None
    if grad_rays is not None:
        m = np.zeros(R, bool)
        m[grad_rays] = True

        def jloss(s, c):
            o = jout(s, c)
            return jnp.sum(jnp.where(m[:, None], o["rgb"], 0.0)) + jnp.sum(
                jnp.where(m, o["opacity"], 0.0))

        jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(sig),
                                                      jnp.asarray(rgb))
        mt = torch.as_tensor(m)
        (torch.where(mt[:, None], got["rgb"], 0.0).sum()
         + torch.where(mt, got["opacity"], 0.0).sum()).backward()
        grads = ((st.grad.numpy(), ct.grad.numpy()),
                 tuple(np.asarray(g) for g in jg))
    return ({k: v.detach().numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, ray_mask, grads)


@pytest.mark.parametrize("budget,prefix", [(1024, True), (300, True),
                                           (400, False)])
def test_stream_values_and_gradients_equal_jax(budget, prefix):
    valid, sig, rgb, dt, ts = _fixture(0 if prefix else 3, prefix=prefix)
    got, want, ray_mask, grads = _stream_both(valid, sig, rgb, dt, ts, budget,
                                              grad_rays=np.arange(0, 64, 3))
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    (gs, gc), (jgs, jgc) = grads
    np.testing.assert_allclose(gs, jgs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gc, jgc, rtol=1e-5, atol=1e-5)
    # against the padded composite on every ray the budget kept whole
    ref = jcomp(sig, rgb, dt, ts, valid, 1e-4)
    for k in ("opacity", "depth", "depth_sq", "rgb"):
        np.testing.assert_allclose(got[k][ray_mask],
                                   np.asarray(ref[k])[ray_mask], rtol=2e-5,
                                   atol=1e-5, err_msg=k)
    assert ray_mask.all() == (valid.sum() <= budget)


def test_inf_sigma_does_not_poison_later_rays():
    """One trunc_exp overflow (sigma = inf) saturates only its ray: every
    output and every other ray's gradient stays finite."""
    R, K = 8, 4
    valid = np.ones((R, K), bool)
    sig = np.full((R, K), 5.0, np.float32)
    sig[2, 1] = np.inf
    rgb = np.full((R, K, 3), 0.5, np.float32)
    ts = np.tile(np.arange(K, dtype=np.float32)[None] * 0.01 + 0.1, (R, 1))
    dt = np.full((R, K), 0.01, np.float32)
    others = np.arange(R) != 2
    got, want, _, grads = _stream_both(valid, sig, rgb, dt, ts, R * K,
                                       grad_rays=np.flatnonzero(others))
    for k in ("opacity", "depth", "rgb", "tau"):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    (gs, _), _ = grads
    assert np.isfinite(gs[others]).all()


def test_empty_ray_opacity_never_negative_and_loss_finite():
    """Mostly empty rays beside a few with large optical depth: opacity
    is never negative and the loss stays finite, for adversarially
    negative opacity too."""
    R, K = 32, 8
    valid = np.zeros((R, K), bool)
    valid[::8] = True
    sig = np.full((R, K), 1e4, np.float32)
    rgb = np.full((R, K, 3), 0.3, np.float32)
    ts = np.tile(np.arange(K, dtype=np.float32)[None] * 0.01 + 0.1, (R, 1))
    dt = np.where(valid, 0.01, 0.0).astype(np.float32)
    got, want, _, _ = _stream_both(valid, sig, rgb, dt, ts, R * K)
    assert got["opacity"].min() >= 0.0
    np.testing.assert_allclose(got["opacity"], want["opacity"], atol=1e-5)
    batch = {"rgb": torch.full((R, 3), 0.5)}
    res = {k: torch.as_tensor(v) for k, v in got.items()}
    res["ray_mask"] = torch.ones(R, dtype=torch.bool)
    assert torch.isfinite(NeRFLoss().total(res, batch)[0])
    res["opacity"] = torch.full((R,), -1e-7)
    assert torch.isfinite(NeRFLoss().total(res, batch)[0])
