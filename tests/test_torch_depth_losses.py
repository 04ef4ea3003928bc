"""The port's depth losses and normals (google_nerf_tpu_torch/depth/
losses.py, normals.py) on the CPU: every case of
tests/test_depth_losses.py run on the port, then each loss, the normals
and `depth_losses` in every mode its docstring lists (auxi too) against
JAX's on the same seeded numpy inputs, with JAX's draws handed in:
`jax_loss_draws` makes, from JAX's key, the Gumbel and randint draws
JAX's functions make inside (the same splits), in the port's draws
layout.

Tolerances: values rtol 1e-5 (atol 1e-6 where a loss is near 0); the
gradient with respect to pred norm-relative 1e-5 (f32 sums and
convolutions in another order); sampled indices, pair indices and their
masks exactly equal; the normals 1e-5.  JAX's gradient through
pwn_planes_loss is NaN at a plane's sampled points when the filter drops
every group of that plane (the norm of their zero mean normal: 0/0),
always so for a plane id that no pixel holds, and where a group's
points coincide; the port's, as the reference's torch norm, is 0 along
that path.  So pwn_planes_loss's gradient is held to JAX's where JAX's
is finite; in `depth_losses` the scale/shift fit spreads JAX's NaN to
every pixel, so there the port's gradient with a planes term must be
finite, and its values equal JAX's.  JAX's rgb is NHWC, the port's
NCHW."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.depth import losses as jl
from google_nerf_tpu.depth import normals as jn
from google_nerf_tpu_torch.depth import losses as tl
from google_nerf_tpu_torch.depth import normals as tn
from google_nerf_tpu_torch.depth.metrics import (evaluate_rel_err,
                                                 recover_metric_depth)

KEY = jax.random.PRNGKey(0)
GEN = 0
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these networks are small, and the test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=GEN):
    return torch.Generator().manual_seed(seed)


def _t(x, dtype=None):
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None
                                                 else a.astype(dtype)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# ------------------------------------------------------ JAX's own draws


def _edge_draw(key, n, n_pairs):
    k1, k2, _ = jax.random.split(key, 3)
    return (jax.random.gumbel(k1, (n,)),
            jax.random.randint(k2, (4, n_pairs), 2, 31))


def _rand_draw(key, n):
    k1, k2 = jax.random.split(key)
    return jnp.stack([jax.random.gumbel(k1, (n,)),
                      jax.random.gumbel(k2, (n,))])


def _ranking_draws(key, b, n, n_pairs):
    eg, ed, rg = [], [], []
    for kb in jax.random.split(key, b):
        ke, kr = jax.random.split(kb)
        g, d = _edge_draw(ke, n, n_pairs)
        eg.append(g), ed.append(d), rg.append(_rand_draw(kr, n))
    return dict(edge_gumbel=np.stack(eg), edge_dist=np.stack(ed),
                rand_gumbel=np.stack(rg))


def _pwn_edges_draws(key, b, n, n_pairs):
    eg, ed, rg = [], [], []
    for kb in jax.random.split(key, b):
        k1, k2, k3 = jax.random.split(kb, 3)
        (g1, d1), (g2, d2) = (_edge_draw(k, n, n_pairs) for k in (k1, k2))
        eg.append(np.stack([g1, g2])), ed.append(np.stack([d1, d2]))
        rg.append(_rand_draw(k3, n))
    return dict(edge_gumbel=np.stack(eg), edge_dist=np.stack(ed),
                rand_gumbel=np.stack(rg))


def _planes_draws(key, b, n, max_planes):
    return dict(gumbel=np.stack([
        np.stack([np.stack([jax.random.gumbel(k, (n,))
                            for k in jax.random.split(kp, 3)])
                  for kp in jax.random.split(kb, max_planes)])
        for kb in jax.random.split(key, b)]))


def to_port(draws):
    """numpy draws -> torch (the dist integers as int64)."""
    if isinstance(draws, dict):
        return {k: to_port(v) for k, v in draws.items()}
    a = np.asarray(draws)
    return torch.from_numpy(a.astype(np.int64 if a.dtype.kind == "i"
                                     else np.float32))


def jax_loss_draws(key, b, h, w, n_pairs=2048, max_planes=8):
    """The draws jl.depth_losses(key, ...) makes, per loss, in the port's
    layout (torch tensors)."""
    keys = jax.random.split(key, 4)
    n = h * w
    return to_port(dict(planes=_planes_draws(keys[0], b, n, max_planes),
                        pwn_edges=_pwn_edges_draws(keys[1], b, n, n_pairs),
                        ranking=_ranking_draws(keys[2], b, n, n_pairs),
                        ranking_auxi=_ranking_draws(keys[3], b, n,
                                                    n_pairs)))


# ------------------------------------------------------------- inputs


def _inputs(b=2, h=32, w=32, seed=0, planes=False):
    """A smooth depth with noise, a prediction an affine map of it plus
    noise (so the scale/shift fit is well posed), random colours."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    gt = (1.5 + 0.5 * np.sin(xx / 5.0 + np.arange(b)[:, None, None])
          + 0.4 * np.cos(yy / 7.0) + rng.normal(0, 0.02, (b, h, w)))
    pred = 0.6 * gt - 0.2 + rng.normal(0, 0.05, (b, h, w))
    gt = gt.astype(np.float32)
    gt[0, :3, :7] = -1.0                      # a few invalid pixels
    d = dict(
        pred=pred.astype(np.float32),
        depth=gt,
        rgb=rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        focal_length=np.full((b,), 100.0, np.float32),
        quality_flg=np.asarray([3, 2][:b] + [1] * max(b - 2, 0), np.int32),
        disp=rng.uniform(0.1, 2, (b, h, w)).astype(np.float32),
        auxi=rng.uniform(0.1, 2, (b, h, w)).astype(np.float32),
        planes=np.zeros((b, h, w), np.int32))
    if planes:                  # eight bands of plane ids, some pixels none
        d["planes"] = np.broadcast_to(
            (np.arange(h)[:, None] * 8 // h + 1) * (np.arange(w) > 1),
            (b, h, w)).astype(np.int32)
    return d


def _jax_data(d):
    return {k: jnp.asarray(d[k]) for k in ("depth", "rgb", "focal_length",
                                           "quality_flg", "planes", "disp")}


def _port_data(d):
    out = {k: _t(d[k]) for k in ("depth", "focal_length", "quality_flg",
                                 "disp")}
    out["rgb"] = _t(d["rgb"].transpose(0, 3, 1, 2))
    out["planes"] = _t(d["planes"], np.int64)
    return out


# --------------------------------- tests/test_depth_losses.py, on the port


def test_recover_scale_shift_exact():
    rng = np.random.default_rng(0)
    pred = _t(rng.uniform(0.5, 2.0, (2, 16, 16)).astype(np.float32))
    gt = 3.0 * pred + 0.7
    out = tl.recover_scale_shift_depth(pred, gt)
    np.testing.assert_allclose(out.numpy(), gt.numpy(), rtol=1e-3)


def test_recover_scale_shift_masked():
    rng = np.random.default_rng(1)
    pred = _t(rng.uniform(0.5, 2.0, (1, 8, 8)).astype(np.float32))
    gt = 2.0 * pred + 1.0
    gt[0, :4] = -1.0
    out = tl.recover_scale_shift_depth(pred, gt)
    np.testing.assert_allclose(out[0, 4:].numpy(), gt[0, 4:].numpy(),
                               rtol=1e-3)


def test_ilnr_perfect_pred_zero():
    gt = _t(np.random.default_rng(0).uniform(
        0.1, 10.0, (2, 32, 32)).astype(np.float32))
    assert float(tl.ilnr_loss(gt, gt)) == pytest.approx(0.0, abs=1e-6)


def test_ilnr_hand_value():
    gt = torch.full((1, 16, 16), 2.0)
    pred = torch.full((1, 16, 16), 3.0)
    expect = 1.0 + abs(np.tanh(0.02) - np.tanh(0.03))
    assert float(tl.ilnr_loss(pred, gt)) == pytest.approx(expect, rel=1e-5)


def test_ilnr_invalid_image_skipped():
    gt = torch.stack([torch.full((8, 8), -1.0), torch.full((8, 8), 2.0)])
    assert float(tl.ilnr_loss(torch.ones((2, 8, 8)), gt)) == 0.0


def test_msgil_zero_for_constant_offset():
    gt = _t(np.random.default_rng(0).uniform(
        0.1, 5.0, (1, 32, 32)).astype(np.float32))
    assert float(tl.msgil_loss(gt + 1.5, gt).sum()) == pytest.approx(
        0.0, abs=1e-5)


def test_msgil_positive_for_gradient_mismatch():
    gt = torch.ones((1, 32, 32))
    pred = _t(np.random.default_rng(0).normal(
        size=(1, 32, 32)).astype(np.float32))
    assert float(tl.msgil_loss(pred, gt).sum()) > 0.01


def test_sample_masked_indices_uniform_valid():
    mask = torch.zeros(1024, dtype=torch.bool)
    mask[100:200] = True
    idx, ok = tl.sample_masked_indices(mask, 50,
                                       tl.gumbel((1024,), _gen(), "cpu"))
    assert bool(ok.all())
    assert bool(((idx >= 100) & (idx < 200)).all())
    assert len(np.unique(idx.numpy())) == 50        # without replacement


def test_sobel_edges_detects_step():
    img = torch.zeros((1, 16, 16))
    img[:, :, 8:] = 1.0
    edges, _ = tl.sobel_edges(img)
    assert float(edges[0, 8, 7:9].max()) > 1.0
    assert float(edges[0, 8, 2]) == 0.0


def test_ranking_loss_orders_correctly():
    rng = np.random.default_rng(0)
    gt = _t(rng.uniform(1.0, 5.0, (1, 32, 32)).astype(np.float32))
    rgb = _t(rng.uniform(0, 1, (1, 3, 32, 32)).astype(np.float32))
    good = tl.ranking_loss(gt, gt, rgb, n_pairs=512, generator=_gen())
    bad = tl.ranking_loss(-gt, gt, rgb, n_pairs=512, generator=_gen())
    assert float(bad.sum()) > float(good.sum())


def test_surface_normal_flat_plane():
    n = tn.surface_normal_from_depth(torch.full((1, 32, 32), 2.0),
                                     torch.tensor([100.0]),
                                     torch.ones((1, 32, 32), dtype=bool))
    assert float(n[0, 2, 8:-8, 8:-8].abs().min()) > 0.95


def test_depth_to_xyz_center_ray():
    xyz = tn.depth_to_xyz(torch.full((1, 9, 9), 3.0), torch.tensor([50.0]))
    c = xyz[0, :, 4, 4]
    assert float(c[2]) == pytest.approx(3.0)
    assert abs(float(c[0])) < 0.05 and abs(float(c[1])) < 0.05


def test_box_blur_constant():
    y = tn.box_blur_3x3(torch.full((1, 8, 8), 4.0))
    assert float(y[0, 4, 4]) == pytest.approx(4.0, rel=1e-6)
    assert float(y[0, 0, 0]) == pytest.approx(4.0 * 4 / 9, rel=1e-6)


def test_pwn_edges_runs_and_zero_for_perfect():
    rng = np.random.default_rng(0)
    gt = _t(rng.uniform(1.0, 5.0, (1, 32, 32)).astype(np.float32))
    rgb = _t(rng.uniform(0, 1, (1, 3, 32, 32)).astype(np.float32))
    f = torch.tensor([100.0])
    same = tl.pwn_edges_loss(gt, gt, rgb, f, n_pairs=256, generator=_gen())
    assert float(same.sum()) == pytest.approx(0.0, abs=1e-4)
    diff = tl.pwn_edges_loss(1.0 / gt, gt, rgb, f, n_pairs=256,
                             generator=_gen())
    assert float(diff.sum()) >= float(same.sum())


def test_pwn_planes_flat_plane_zero():
    h = w = 32
    v = torch.arange(h, dtype=torch.float32)[:, None]
    depth = (2.0 + 0.01 * v).expand(1, h, w)
    planes = torch.ones((1, h, w), dtype=torch.int64)
    loss = tl.pwn_planes_loss(depth, depth, planes, torch.tensor([100.0]),
                              sample_groups=128, max_planes=2,
                              generator=_gen())
    assert float(loss) == pytest.approx(0.0, abs=5e-2)


def test_orchestrator_modes_and_raw():
    d = _inputs()
    pred = _t(d["pred"]).requires_grad_(True)
    data = _port_data(d)
    cfg = tl.LossConfig(loss_mode="_ranking-edge_msgil-normal_meanstd-tanh_"
                        "_pairwise-normal-regress-edge_")
    out = tl.depth_losses(pred, data, cfg, generator=_gen())
    assert out["total_raw"].shape == (2,)
    assert np.isfinite(float(out["total_loss"].detach()))
    for k in ("ranking-edge_loss", "msg_normal_loss", "meanstd-tanh_loss",
              "pairwise-normal-regress-edge_loss"):
        assert k in out, k
    out2 = tl.depth_losses(pred, data,
                           tl.LossConfig(loss_mode="_meanstd-tanh_"))
    assert "ranking-edge_loss" not in out2
    out["total_loss"].backward()
    assert bool(torch.isfinite(pred.grad).all())


def test_depth_metrics_battery():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0.5, 5.0, (64, 64))
    pred = 2.0 * gt + 0.3
    np.testing.assert_allclose(recover_metric_depth(pred, gt), gt,
                               rtol=1e-6)
    m = evaluate_rel_err(pred, gt)
    assert m["err_absRel"] == pytest.approx(0.0, abs=1e-6)
    assert m["err_delta1"] == 1.0
    assert m["err_whdr"] == pytest.approx(0.0, abs=1e-6)
    m2 = evaluate_rel_err(1.0 / gt, gt, scale_fit=False)
    assert m2["err_absRel"] > 0.1


def test_sampled_losses_need_draws_or_a_generator():
    d = _inputs(b=1, h=16, w=16)
    with pytest.raises(ValueError, match="draws or a torch.Generator"):
        tl.ranking_loss(_t(d["pred"]), _t(d["depth"]),
                        _t(d["rgb"].transpose(0, 3, 1, 2)))


# ---------------------------------------------------------- against JAX


def test_normals_match_jax():
    d = _inputs()
    f, mask = d["focal_length"], d["depth"] > 0
    jx = jn.depth_to_xyz(jnp.asarray(d["pred"]), jnp.asarray(f))
    tx = tn.depth_to_xyz(_t(d["pred"]), _t(f))
    np.testing.assert_allclose(tx.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jx), rtol=REL, atol=1e-6)
    np.testing.assert_allclose(
        tn.box_blur_3x3(_t(d["pred"])).numpy(),
        np.asarray(jn.box_blur_3x3(jnp.asarray(d["pred"]))), rtol=REL,
        atol=1e-6)
    np.testing.assert_allclose(
        tn.get_surface_normal_v2(tx).numpy().transpose(0, 2, 3, 1),
        np.asarray(jn.get_surface_normal_v2(jx)), rtol=REL, atol=1e-5)
    jnrm = jn.surface_normal_from_depth(jnp.asarray(d["pred"]),
                                        jnp.asarray(f), jnp.asarray(mask))
    tnrm = tn.surface_normal_from_depth(_t(d["pred"]), _t(f), _t(mask))
    np.testing.assert_allclose(tnrm.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jnrm), rtol=REL, atol=1e-5)


def test_sampled_indices_equal_jax():
    """The masked Gumbel top-k (fewer and more asked than the mask
    holds), the edge-guided pairs and the random pairs: exactly JAX's
    indices from JAX's draws."""
    d = _inputs(b=1)
    n = 32 * 32
    mask = d["depth"][0].reshape(-1) > 0.7
    for n_draw, key in ((50, 3), (int(mask.sum()) + 100, 4), (3 * n, 5)):
        k = jax.random.PRNGKey(key)
        ji, jo = jl.sample_masked_indices(k, jnp.asarray(mask), n_draw)
        ti, to = tl.sample_masked_indices(
            _t(mask), n_draw, to_port(jax.random.gumbel(k, (n,))))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    je, jt = jl.sobel_edges(jnp.asarray(d["rgb"][..., 0]))
    te, tt = tl.sobel_edges(_t(d["rgb"][..., 0]))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=REL,
                               atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=REL,
                               atol=1e-6)
    k = jax.random.PRNGKey(6)
    want = jl._edge_guided_pairs(k, 32, 32, je[0].reshape(-1),
                                 jt[0].reshape(-1), 700)
    g, dist = (to_port(x) for x in _edge_draw(k, n, 700))
    got = tl._edge_guided_pairs(32, 32, te.reshape(1, -1),
                                tt.reshape(1, -1), 700, g[None], dist[None])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    want = jl._random_pairs(k, jnp.asarray(mask), 900)
    got = tl._random_pairs(_t(mask)[None], 900,
                           to_port(_rand_draw(k, n))[None])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


def _value_and_grad_jax(fn, pred):
    v, g = jax.jit(jax.value_and_grad(lambda p: jnp.sum(fn(p))))(
        jnp.asarray(pred))
    return float(v), np.asarray(g)


def _value_and_grad_port(fn, pred):
    p = _t(pred).requires_grad_(True)
    v = fn(p).sum()
    v.backward()
    return float(v.detach()), p.grad.numpy()


def _check(tv, tg, jv, jg, atol=1e-6):
    """Values rtol 1e-5; the gradient norm-relative 1e-5 where JAX's is
    finite, the port's finite everywhere."""
    assert tv == pytest.approx(jv, rel=REL, abs=atol), (tv, jv)
    fin = np.isfinite(jg)
    assert np.isfinite(tg).all() and fin.mean() > 0.5, fin.mean()
    assert _rel(tg[fin], jg[fin]) <= REL, _rel(tg[fin], jg[fin])


@pytest.mark.parametrize("loss", ["ilnr", "msgil", "scale_shift", "ranking",
                                  "pwn_edges", "pwn_planes"])
def test_each_loss_matches_jax(loss):
    d = _inputs(planes=loss == "pwn_planes")
    b, h, w = d["pred"].shape
    gt, jrgb, trgb = d["depth"], jnp.asarray(d["rgb"]), _t(
        d["rgb"].transpose(0, 3, 1, 2))
    f = d["focal_length"]
    k = jax.random.PRNGKey(11)
    if loss == "ilnr":
        jfn = lambda p: jl.ilnr_loss(p, jnp.asarray(gt))
        tfn = lambda p: tl.ilnr_loss(p, _t(gt))
    elif loss == "msgil":
        jfn = lambda p: jl.msgil_loss(p, jnp.asarray(gt))
        tfn = lambda p: tl.msgil_loss(p, _t(gt))
    elif loss == "scale_shift":   # a weighted sum: sum(fit^2) cancels
        wt = np.random.default_rng(5).uniform(-1, 1, gt.shape).astype(
            np.float32)
        jfn = lambda p: jl.recover_scale_shift_depth(
            p, jnp.asarray(gt)) * wt
        tfn = lambda p: tl.recover_scale_shift_depth(p, _t(gt)) * _t(wt)
    elif loss == "ranking":
        dr = to_port(_ranking_draws(k, b, h * w, 2048))
        jfn = lambda p: jl.ranking_loss(k, p, jnp.asarray(gt), jrgb)
        tfn = lambda p: tl.ranking_loss(p, _t(gt), trgb, draws=dr)
    elif loss == "pwn_edges":
        dr = to_port(_pwn_edges_draws(k, b, h * w, 2048))
        jfn = lambda p: jl.pwn_edges_loss(k, p, jnp.asarray(gt), jrgb,
                                          jnp.asarray(f))
        tfn = lambda p: tl.pwn_edges_loss(p, _t(gt), trgb, _t(f), draws=dr)
    else:   # two planes of 480 px, 8 groups: no point repeats in a group
        planes = (d["planes"] > 4).astype(np.int32) + (d["planes"] > 0)
        dr = to_port(_planes_draws(k, b, h * w, 2))
        jfn = lambda p: jl.pwn_planes_loss(k, jnp.asarray(gt), p,
                                           jnp.asarray(planes),
                                           jnp.asarray(f), sample_groups=8,
                                           max_planes=2)
        tfn = lambda p: tl.pwn_planes_loss(_t(gt), p, _t(planes), _t(f),
                                           sample_groups=8, max_planes=2,
                                           draws=dr)
    jv, jg = _value_and_grad_jax(jfn, d["pred"])
    tv, tg = _value_and_grad_port(tfn, d["pred"])
    assert jv != 0.0
    _check(tv, tg, jv, jg)


# every flag of depth_losses' docstring: the CLI's default three, the
# edges alone (its scale/shift fit's gradient), all five main flags (the
# planes' gradient is NaN in JAX), and the three auxi flags
MODES = {
    "edges": "_pairwise-normal-regress-edge_",
    "cli_default": "_ranking-edge_msgil-normal_meanstd-tanh_",
    "all": ("_ranking-edge_msgil-normal_meanstd-tanh_"
            "_pairwise-normal-regress-edge__pairwise-normal-regress-plane_"),
    "auxi": ("_ranking-edge_msgil-normal_meanstd-tanh_ranking-edge-auxi_"
             "msgil-normal-auxi_meanstd-tanh-auxi_"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_depth_losses_match_jax(mode):
    """Every named loss, total_raw and total_loss rtol 1e-5; the gradient
    of total_loss with respect to pred norm-relative 1e-5 (with the
    planes term: finite; JAX's is NaN, see the module docstring)."""
    d = _inputs(planes=mode == "all")
    b, h, w = d["pred"].shape
    cfg_j = jl.LossConfig(loss_mode=MODES[mode])
    cfg_t = tl.LossConfig(loss_mode=MODES[mode])
    key = jax.random.PRNGKey(7)
    jdata = _jax_data(d)
    tdata = _port_data(d)
    dr = jax_loss_draws(key, b, h, w)
    with_auxi = mode == "auxi"

    def jfn(p, a):
        out = jl.depth_losses(key, p, jdata, cfg_j,
                              auxi=a if with_auxi else None)
        return out["total_loss"], out

    (jv, jout), (jg, jga) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(d["pred"]),
                                            jnp.asarray(d["auxi"]))
    p = _t(d["pred"]).requires_grad_(True)
    a = _t(d["auxi"]).requires_grad_(True)
    tout = tl.depth_losses(p, tdata, cfg_t, auxi=a if with_auxi else None,
                           draws=dr)
    tout["total_loss"].backward()
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=REL, atol=1e-6,
                                   err_msg=k)
    jg, tg = np.asarray(jg), p.grad.numpy()
    assert np.isfinite(tg).all()
    if "plane" not in MODES[mode]:
        assert _rel(tg, jg) <= REL, _rel(tg, jg)
    if with_auxi:
        assert _rel(a.grad.numpy(), jga) <= REL
        assert "ranking-edge_auxiloss" in tout
