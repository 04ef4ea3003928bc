"""Dense brick-field kernels K3 (brick_field_tiles), K4
(brick_field_tiles_t) and K5 (brick_field_tiles_rgba) of the PyTorch port:
the plain versions against the numpy goldens and the JAX entries in
interpret mode, mirroring tests/test_render_brick_mxu.py:71, :89, :205,
:305 and :386 (the card-only kernel tests are in test_torch_cuda.py).

Tolerances are those of tests/test_render_brick_mxu.py: the kernels
round the slab, corner products and MLP operands to bf16 while the
goldens are f32/f64, so tau agrees to atol/rtol 5e-2, rgb and depth to
atol 3e-2, and n_pairs exactly.  Against the JAX entries, which round
alike, the same tolerances hold with room to spare."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.ops.pallas import brick_field as jbf
from google_nerf_tpu_torch.ops.cuda import brick_field as tbf
from test_torch_cuda import (_assert_matches, _dense_call, _torch,
                             _toy_inputs, _toy_rgba_pool)

JAX_KW = dict(inv2s=1.0, V=32, interpret=True)


def _jax(kernel, args, nslots, kw, init=None):
    """The JAX entry of `kernel` on the toy inputs, in interpret mode."""
    a = [jnp.asarray(x) for x in args]
    ns = jnp.asarray(nslots)
    if kernel == "n":
        return np.asarray(jbf.brick_field_tiles(*a, nslots=ns, **JAX_KW,
                                                **kw))
    if kernel == "t":
        a[4] = jnp.swapaxes(a[4], 1, 2)
        return np.asarray(jbf.brick_field_tiles_t(*a, nslots=ns, **JAX_KW,
                                                  **kw))
    return np.asarray(jbf.brick_field_tiles_rgba(
        *a[:3], jnp.asarray(_toy_rgba_pool(args[4])), nslots=ns,
        init=None if init is None else jnp.asarray(init), **JAX_KW, **kw))


def _golden(kernel, args, nslots, kw):
    if kernel == "rgba":
        return jbf.brick_field_rgba_reference(
            *args[:3], _toy_rgba_pool(args[4]), nslots=nslots, inv2s=1.0,
            V=32, **kw)
    return jbf.brick_field_tiles_reference(*args, nslots=nslots, inv2s=1.0,
                                           V=32, **kw)


@pytest.mark.parametrize("kernel,Bk", [("n", 8), ("t", 8), ("rgba", 8),
                                       ("n", 4), ("t", 4), ("rgba", 4)])
def test_dense_plain_matches_golden_and_jax(kernel, Bk):
    """Bk=8 and the Bk=4 slab geometry (64-voxel bricks); tile 0 has a
    pad slot at its list tail (the nslots gate)."""
    args, nslots, kw = _toy_inputs(Lp=4, Bk=Bk)
    fn, _, t, extra = _dense_call(kernel, args, nslots)
    got = fn(*t, **extra, **kw).numpy()
    _assert_matches(got, _golden(kernel, args, nslots, kw))
    _assert_matches(got, _jax(kernel, args, nslots, kw))
    assert got[:, 5].sum() > 0
    misses = got[:, 5] == 0
    assert np.all(got[misses, 0] == 0)


@pytest.mark.parametrize("kernel", ["n", "t", "rgba"])
def test_dense_plain_early_termination_matches_golden(kernel):
    """An opaque first brick stops the composite: later bricks add no
    colour, the pair counter freezes, opacity saturates (the JAX test's
    three-slot lists)."""
    args, nslots, kw = _toy_inputs(sigma_scale=0.0)
    args = list(args)
    args[4] = args[4].copy()
    args[4][0, :, 0::16] = 9.0          # e^9 * dt >> tau_max in brick 0
    fn, _, t, extra = _dense_call(kernel, args, nslots)
    got = fn(*t, **extra, **kw).numpy()
    want = _golden(kernel, args, nslots, kw)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_array_equal(got[:, 5], _jax(kernel, args, nslots,
                                                  kw)[:, 5])
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], atol=3e-2)
    hit = got[:, 5] > 0
    assert hit.any() and np.all(got[hit, 5] < nslots[0] + 2)
    assert np.all(1.0 - np.exp(-got[hit, 0]) > 0.98)


def test_rgba_plain_init_carry_matches_jax():
    """K5 resumes each listed tile from its init row, as the JAX entry
    does (segmented rendering's carry)."""
    args, nslots, kw = _toy_inputs(Lp=4)
    rng = np.random.RandomState(5)
    init = np.zeros((128, 8), np.float32)
    init[:, 0] = rng.uniform(0.0, 3.0, 128)
    init[:, 1:5] = rng.uniform(0.0, 0.5, (128, 4))
    init[:, 5] = rng.randint(0, 3, 128)
    init[::7, 0] = 6.0                 # some rays already saturated
    fn, _, t, extra = _dense_call("rgba", args, nslots)
    got = fn(*t, **extra, init=torch.as_tensor(init), **kw).numpy()
    _assert_matches(got, _jax("rgba", args, nslots, kw, init=init))
    assert np.all(got[::7, 5] == init[::7, 5])


def test_tp_plain_window_span_65_matches_jax():
    """A window span above the old cap of 64 (test.py's 512-sample
    lattice on a 64^3 bake gives S = 65): rays cross a brick in ~74
    samples at dt = sqrt(3)/512, so both sides truncate at 65 samples."""
    args, nslots, kw = _toy_inputs(Lp=4)
    kw = dict(kw, S=65, dt=float(np.sqrt(3) / 512))
    got = tbf.brick_field_tiles_tp(*_torch(args), nslots=torch.as_tensor(
        nslots), P=2, **kw).numpy()
    a = [jnp.asarray(x) for x in args]
    a[4] = jnp.swapaxes(a[4], 1, 2)
    want = np.asarray(jbf.brick_field_tiles_tp(
        *a, nslots=jnp.asarray(nslots), P=2, **JAX_KW, **kw))
    _assert_matches(got, want)
    _assert_matches(got, _golden("n", args, nslots, kw))
    assert got[:, 5].sum() > 0


@pytest.mark.parametrize("Bk,sub", [(8, False), (8, True), (4, False)])
def test_port_rgba_golden_matches_jax_golden(Bk, sub):
    """The port's copy of the rgba golden is the JAX package's, bit for
    bit, with and without tid/lbase list addressing."""
    args, nslots, kw = _toy_inputs(Lp=4, Bk=Bk)
    extra = dict(nslots=nslots)
    if sub:
        extra = dict(tid=np.array([0], np.int32), lbase=np.array([4]),
                     nslots=nslots[1:])
    rgba = _toy_rgba_pool(args[4])
    got = tbf.brick_field_rgba_reference(*args[:3], rgba, inv2s=1.0, V=32,
                                         **kw, **extra)
    want = jbf.brick_field_rgba_reference(*args[:3], rgba, inv2s=1.0, V=32,
                                          **kw, **extra)
    np.testing.assert_array_equal(got, want)
    assert got[:, 5].sum() > 0


def test_dense_out_in_place_keeps_unlisted_tiles():
    """K3 and K4 render each listed tile from zero into `out`, whatever
    it held, and keep every other row (JAX leaves them undefined)."""
    args, nslots, kw = _toy_inputs(Lp=4)
    for kernel in ("n", "t"):
        fn, _, t, extra = _dense_call(kernel, args, nslots)
        full = fn(*t, **extra, **kw)
        out = torch.full((128, 8), 0.25)
        keep = out[64:].clone()
        got = fn(*t, tid=torch.tensor([0]), nslots=extra["nslots"][:1],
                 out=out, **kw)
        assert got.data_ptr() == out.data_ptr()
        torch.testing.assert_close(got[64:], keep, rtol=0, atol=0)
        torch.testing.assert_close(got[:64], full[:64], rtol=0, atol=0)


def test_dense_wrappers_reject_bad_arguments():
    args, nslots, kw = _toy_inputs(Lp=4)
    t = _torch(args)
    with pytest.raises(ValueError, match="pool: shape"):
        tbf.brick_field_tiles_t(*t, **kw)            # untransposed pool
    tT = list(t)
    tT[4] = t[4].transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="pool: shape"):
        tbf.brick_field_tiles(*tT, **kw)             # transposed pool
    with pytest.raises(ValueError, match="pool: shape"):
        tbf.brick_field_tiles_rgba(*t[:3], t[4], **kw)
    with pytest.raises(TypeError, match="init"):
        tbf.brick_field_tiles(*t, init=torch.zeros(128, 8), **kw)
    with pytest.raises(ValueError, match="distinct"):
        tbf.brick_field_tiles_t(*tT, tid=torch.tensor([1, 1]), **kw)
    with pytest.raises(ValueError, match="S=0"):
        tbf.brick_field_tiles(*t, **dict(kw, S=0))
