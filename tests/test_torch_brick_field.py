"""Brick-field kernels K1 (worklist) and K2 (tile grid) of the PyTorch
port: the plain versions against the numpy golden and the JAX entries in
interpret mode (the card-only kernel tests are in test_torch_cuda.py);
K5's corner-weight form beside K1's and K2's.
Tolerances are those of tests/test_render_brick_mxu.py: the kernels
round the slab, corner products and MLP operands to bf16 while the
golden is f32/f64, so tau agrees to atol/rtol 5e-2, rgb and depth to
atol 3e-2, and n_pairs exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops.pallas import brick_field as jbf
from google_nerf_tpu_torch.ops.cuda import brick_field as tbf
from test_torch_cuda import (_assert_matches, _torch, _toy_inputs,
                             _toy_rgba_pool, _worklist)


def _golden(args, nslots, kw, **extra):
    return jbf.brick_field_tiles_reference(*args, nslots=nslots, inv2s=1.0,
                                           V=32, **kw, **extra)


def _jax_tp(args, nslots, kw, P, init=None):
    a = [jnp.asarray(x) for x in args]
    a[4] = jnp.swapaxes(a[4], 1, 2)            # the TPU's transposed pool
    return np.asarray(jbf.brick_field_tiles_tp(
        *a, nslots=jnp.asarray(nslots), P=P, inv2s=1.0, V=32,
        init=None if init is None else jnp.asarray(init), interpret=True,
        **kw))


def _jax_wl(args, wl_args, kw, P, init=None):
    a = [jnp.asarray(x) for x in args]
    a[4] = jnp.swapaxes(a[4], 1, 2)
    return np.asarray(jbf.brick_field_tiles_wl(
        *a, *[jnp.asarray(x) for x in wl_args], P=P,
        init=None if init is None else jnp.asarray(init), interpret=True,
        **kw))


@pytest.mark.parametrize("P", [2, 4])
def test_tp_plain_matches_golden_and_jax(P):
    args, nslots, kw = _toy_inputs(Lp=4)
    got = tbf.brick_field_tiles_tp(*_torch(args), nslots=torch.as_tensor(
        nslots), P=P, **kw).numpy()
    _assert_matches(got, _golden(args, nslots, kw))
    _assert_matches(got, _jax_tp(args, nslots, kw, P))
    misses = got[:, 5] == 0
    assert np.all(got[misses, 0] == 0)


@pytest.mark.parametrize("P", [2, 4])
def test_wl_plain_matches_golden_and_jax(P):
    """Two tiles, several groups each, pad steps at the worklist tail."""
    args, nslots, kw = _toy_inputs(Lp=4)
    wl_args = _worklist(2, 4, nslots, P)
    got = tbf.brick_field_tiles_wl(*_torch(args), *_torch(wl_args), P=P,
                                   **kw).numpy()
    _assert_matches(got, _golden(args, nslots, kw))
    _assert_matches(got, _jax_wl(args, wl_args, kw, P))


@pytest.mark.parametrize("kernel", ["tp", "wl"])
def test_plain_early_termination_matches_golden(kernel):
    """Opaque first brick: later bricks of the same group composite behind
    the carried tau exactly as sequential slots would."""
    args, nslots, kw = _toy_inputs(Lp=4, sigma_scale=0.0)
    args = list(args)
    args[4] = args[4].copy()
    args[4][0, :, 0::16] = 9.0
    if kernel == "tp":
        got = tbf.brick_field_tiles_tp(*_torch(args), nslots=torch.as_tensor(
            nslots), P=4, **kw).numpy()
        jax_out = _jax_tp(args, nslots, kw, 4)
    else:
        wl_args = _worklist(2, 4, nslots, 4)
        got = tbf.brick_field_tiles_wl(*_torch(args), *_torch(wl_args), P=4,
                                       **kw).numpy()
        jax_out = _jax_wl(args, wl_args, kw, 4)
    want = _golden(args, nslots, kw)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], atol=3e-2)
    np.testing.assert_array_equal(got[:, 5], jax_out[:, 5])
    hit = got[:, 5] > 0
    assert np.all(got[hit, 5] < nslots[0] + 2)


@pytest.mark.parametrize("kernel", ["tp", "wl"])
def test_plain_block4_matches_golden_and_jax(kernel):
    """Bk=4 slab geometry (64-voxel bricks)."""
    args, nslots, kw = _toy_inputs(Lp=4, Bk=4)
    if kernel == "tp":
        got = tbf.brick_field_tiles_tp(*_torch(args), nslots=torch.as_tensor(
            nslots), P=2, **kw).numpy()
        jax_out = _jax_tp(args, nslots, kw, 2)
    else:
        wl_args = _worklist(2, 4, nslots, 2)
        got = tbf.brick_field_tiles_wl(*_torch(args), *_torch(wl_args), P=2,
                                       **kw).numpy()
        jax_out = _jax_wl(args, wl_args, kw, 2)
    _assert_matches(got, _golden(args, nslots, kw))
    _assert_matches(got, jax_out)
    assert got[:, 5].sum() > 0


@pytest.mark.parametrize("kernel", ["tp", "wl"])
def test_plain_init_carry_matches_jax(kernel):
    """A nonzero carry-in resumes the composite: tiles start from their
    init row (tau, rgb, depth, count) exactly as the JAX entries do."""
    args, nslots, kw = _toy_inputs(Lp=4)
    rng = np.random.RandomState(5)
    init = np.zeros((2 * 64, 8), np.float32)
    init[:, 0] = rng.uniform(0.0, 3.0, 128)
    init[:, 1:5] = rng.uniform(0.0, 0.5, (128, 4))
    init[:, 5] = rng.randint(0, 3, 128)
    init[::7, 0] = 6.0                 # some rays already saturated
    if kernel == "tp":
        got = tbf.brick_field_tiles_tp(
            *_torch(args), nslots=torch.as_tensor(nslots), P=2,
            init=torch.as_tensor(init), **kw).numpy()
        want = _jax_tp(args, nslots, kw, 2, init=init)
    else:
        wl_args = _worklist(2, 4, nslots, 2)
        got = tbf.brick_field_tiles_wl(*_torch(args), *_torch(wl_args), P=2,
                                       init=torch.as_tensor(init),
                                       **kw).numpy()
        want = _jax_wl(args, wl_args, kw, 2, init=init)
    _assert_matches(got, want)
    assert np.all(got[:, 5] >= init[:, 5])
    assert np.all(got[::7, 5] == init[::7, 5])


def test_wl_absent_tiles_keep_init_and_out_is_in_place():
    """Tiles missing from the worklist keep their init rows (JAX leaves
    them undefined), and `out=init` updates the carry in place."""
    args, nslots, kw = _toy_inputs(Lp=4)
    wl_args = _worklist(1, 4, nslots, 2)       # tile 0 only
    init = torch.full((128, 8), 0.25)
    init[:, 0] = 0.0
    keep = init[64:].clone()
    got = tbf.brick_field_tiles_wl(*_torch(args), *_torch(wl_args), P=2,
                                   init=init, out=init, **kw)
    assert got.data_ptr() == init.data_ptr()
    torch.testing.assert_close(got[64:], keep, rtol=0, atol=0)
    assert float(got[:64, 5].sum()) > 0


def test_wrappers_reject_bad_arguments():
    args, nslots, kw = _toy_inputs(Lp=4)
    t = _torch(args)
    with pytest.raises(ValueError, match="multiple of P"):
        tbf.brick_field_tiles_tp(*t, nslots=torch.as_tensor(nslots), P=3,
                                 **kw)
    with pytest.raises(ValueError, match="lbase"):
        tbf.brick_field_tiles_tp(*t, lbase=torch.tensor([0, 2]), P=4,
                                 Lcall=4, **kw)
    with pytest.raises(TypeError, match="dtype"):
        bad = list(t)
        bad[2] = bad[2].double()
        tbf.brick_field_tiles_tp(*bad, P=4, **kw)
    with pytest.raises(ValueError, match="shape"):
        bad = list(t)
        bad[5] = bad[5][:16]
        tbf.brick_field_tiles_tp(*bad, P=4, **kw)
    with pytest.raises(ValueError, match="distinct"):
        tbf.brick_field_tiles_tp(*t, tid=torch.tensor([1, 1]), P=4, **kw)


def _first_voxel_flip(seed=0, tries=32):
    """One tile of rays through the brick [0, 1/4]^2 x [-1/2, -1/4] with
    origins in its first voxel column along x and y, where the fraction
    f = u < 1 keeps bits below 2^-24, so that the corner weights (1 - f)
    + bit * (2f - 1) and where(bit, f, 1 - f) can differ in the last bit.
    A seeded search over the rays finds a sample, one of its corners c
    and a bf16 feature-0 value v whose product w_c * v rounds to another
    bf16 under the two forms (the flip of largest size).  Returns the
    tile's kernel inputs with that v at (voxel, corner c, feature 0) and
    every other pool value 0, so tau exposes the flip, and the ray."""
    from test_torch_brick_field_batched import _samples
    args, _, kw = _toy_inputs(T=1, Lp=1, n_blocks=1)
    args = [np.array(a) for a in args]
    args[1][0, 0:2], args[1][0, 3:5] = 0.0, 0.25
    rng = np.random.RandomState(seed)
    vs = torch.tensor(((1 + np.arange(128)[:, None] / 128)
                       * 2.0 ** np.arange(4)).reshape(-1), dtype=torch.float32)
    meta = torch.as_tensor(args[1])
    for _ in range(tries):
        args[2][:, 0:2] = rng.uniform(0.0, 0.03, (64, 2))
        d = np.stack([rng.uniform(-0.01, 0.01, 64),
                      rng.uniform(-0.01, 0.01, 64), np.ones(64)], -1)
        args[2][:, 3:6] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        r = torch.as_tensor(args[2])[None]
        n0, n1, hit = tbf.slab_window(r, meta, kw["dt"])
        n_s = n0[..., None] + torch.arange(kw["S"], dtype=torch.float32)
        ok = hit[..., None] & (n_s <= n1[..., None])
        (_, ri, _), lid, frac, _ = _samples(
            r, meta, n0, ok, kw["S"], torch.tensor(kw["dt"]), kw["Bk"])
        prod = [tbf._bf(w(frac)[..., None] * vs)
                for w in (tbf._lerp_w8, tbf.trilerp_w8)]   # (M, 8, |vs|)
        gap = (prod[0] - prod[1]).abs()
        if bool((gap > 0).any()):
            m, c, k = np.unravel_index(int(gap.argmax()), gap.shape)
            args[4] = np.zeros_like(args[4])
            args[4][0, int(lid[m]), c * 16] = float(vs[k])
            return args, kw, int(ri[m])
    raise AssertionError("no flip found")


def test_k1_k2_take_the_tpu_corner_weights():
    """K1 and K2 take JAX's corner weights (1 - f) + bit * (2f - 1), as
    `_kernel_tp` and `_kernel_wl` do: on inputs where a corner product
    rounds to another bf16 under where(bit, f, 1 - f), each plain tau
    equals its JAX entry's (interpret mode) to rtol 1e-6, and the where
    form misses that ray's tau by far more."""
    args, kw, ray = _first_voxel_flip()
    nslots = np.ones(1, np.int32)
    wl_args = [np.zeros(1, np.int32), np.zeros(1, np.int32),
               np.ones(1, np.int32), np.ones(1, np.int32)]
    t = _torch(args)
    want_tp = _jax_tp(args, nslots, kw, 1)[:, 0]
    want_wl = _jax_wl(args, wl_args, kw, 1)[:, 0]
    got_tp = tbf.brick_field_tiles_tp(*t, nslots=torch.as_tensor(nslots),
                                      P=1, **kw)[:, 0].numpy()
    got_wl = tbf.brick_field_tiles_wl(*t, *_torch(wl_args), P=1,
                                      **kw)[:, 0].numpy()
    np.testing.assert_allclose(got_tp, want_tp, rtol=1e-6)
    np.testing.assert_allclose(got_wl, want_wl, rtol=1e-6)
    where = tbf._tiles_plain(
        t[0], t[1], t[2], torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.as_tensor(nslots),
        torch.zeros(64, 8), tbf._mlp_maker(t[3], t[4], t[5:8], lerp=False),
        S=kw["S"], dt=kw["dt"], tau_max=kw["tau_max"], Lcall=1, Bk=kw["Bk"],
        zero=True)[:, 0].numpy()
    assert abs(where[ray] - want_tp[ray]) > 1e-5 * want_tp[ray]


def test_k5_takes_the_tpu_corner_weights():
    """K5 takes JAX's corner weights (1 - f) + bit * (2f - 1), as
    `_kernel_rgba` does: on the flipped-corner-product input of
    test_k1_k2_take_the_tpu_corner_weights, its sigma value moved to the
    pre-shaded slab's sigma lane, the plain tau equals JAX's
    brick_field_tiles_rgba (interpret mode) to rtol 1e-6, and the where
    form misses that ray's tau by far more."""
    args, kw, ray = _first_voxel_flip()
    rgba = _toy_rgba_pool(args[4])
    nslots = np.ones(1, np.int32)
    want = np.asarray(jbf.brick_field_tiles_rgba(
        *[jnp.asarray(x) for x in args[:3]], jnp.asarray(rgba),
        nslots=jnp.asarray(nslots), inv2s=1.0, V=32, interpret=True,
        **kw))[:, 0]
    t = _torch(args[:3]) + [torch.as_tensor(rgba)]
    got = tbf.brick_field_tiles_rgba(*t, nslots=torch.as_tensor(nslots),
                                     **kw)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)

    def where_field(_):
        def field(bi, ri, blk, lid, frac):
            rows = tbf._bf(t[3][blk, :, lid]).reshape(-1, 8, 4)
            h4 = tbf._bf(tbf.trilerp_w8(frac)[..., None] * rows).sum(-2)
            return h4[:, 0], torch.clamp(h4[:, 1:4], 0.0, 1.0)
        return field
    zero = torch.zeros(1, dtype=torch.int32)
    where = tbf._tiles_plain(
        t[0], t[1], t[2], zero, zero, torch.as_tensor(nslots),
        torch.zeros(64, 8), where_field, S=kw["S"], dt=kw["dt"],
        tau_max=kw["tau_max"], Lcall=1, Bk=kw["Bk"], zero=True)[:, 0].numpy()
    assert abs(where[ray] - want[ray]) > 1e-5 * want[ray]


@pytest.mark.parametrize("Bk,sub", [(8, False), (8, True), (4, False)])
def test_port_golden_matches_jax_golden(Bk, sub):
    """The port's copy of the numpy golden (the JAX-free reference the
    card tests use) is the JAX package's golden, bit for bit, with and
    without tid/lbase list addressing."""
    args, nslots, kw = _toy_inputs(Lp=4, Bk=Bk)
    extra = dict(nslots=nslots)
    if sub:
        # tile 0 walks tile 1's list rows (the same bricks, 4 slots)
        extra = dict(tid=np.array([0], np.int32), lbase=np.array([4]),
                     nslots=nslots[1:])
    got = tbf.brick_field_tiles_reference(*args, inv2s=1.0, V=32, **kw,
                                          **extra)
    want = jbf.brick_field_tiles_reference(*args, inv2s=1.0, V=32, **kw,
                                           **extra)
    np.testing.assert_array_equal(got, want)
    assert got[:, 5].sum() > 0


def test_window_span_matches_jax():
    for ms, Bk, V in [(512, 8, 512), (256, 8, 256), (64, 8, 32)]:
        assert tbf.window_span(ms, Bk, V, 0.5) == jbf.window_span(
            ms, Bk, V, 0.5)
