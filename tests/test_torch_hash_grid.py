"""The hash-grid kernels' premises and plain versions on the CPU
(ops/cuda/hash_grid.py over the plain arithmetic of ops/hash_grid.py;
the kernels themselves are held to these plain versions on the card by
tests/test_torch_hash_grid_cuda.py).

- The kernels hash in native uint32: numpy's uint32 multiply, xor and
  mask give the plain path's int64 indices (`_corner_indices`) for
  corners up to the resolution on every level of the benchmark's hash
  field, its largest coordinates included.  Exact.
- The plain versions compute what models/encoders.hash_encode's plain
  path computes: the features bit for bit, the table gradient and dx of
  autograd's chain (the same payloads summed in the same order: rtol
  1e-6; dx, summed in another order, within 1e-5 of its largest entry).
- The wrappers take the plain versions on CPU tensors, launch nothing,
  and refuse what the kernels do not take (rows of other than 2
  features among them) on every device; hash_encode serves every width
  on CPU tensors."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from google_nerf_tpu_torch.models import encoders as te
from google_nerf_tpu_torch.ops import hash_grid as oh
from google_nerf_tpu_torch.ops.cuda import hash_grid as hg

ROOT = Path(__file__).resolve().parents[1]


def _bench_hash_cfg():
    """The benchmark's hash field (portbench/configs/ngp_hash_s05.json)
    as the program builds it."""
    m = json.loads((ROOT / "portbench/configs/ngp_hash_s05.json")
                   .read_text())["model"]
    return te.hashgrid_config_for_scale(
        m["scale"], num_levels=m["num_levels"], n_features=m["n_features"],
        log2_hashmap_size=m["log2_hashmap_size"],
        base_resolution=m["base_resolution"])


def _uint32_index(c, res, T):
    """The kernels' index arithmetic in numpy uint32 (wrapping)."""
    c = c.astype(np.uint32)
    if (res + 1) ** 3 <= T:
        r1 = np.uint32(res + 1)
        idx = c[:, 0] + c[:, 1] * r1 + c[:, 2] * r1 * r1
    else:
        idx = ((c[:, 0] * np.uint32(oh._PRIMES[0]))
               ^ (c[:, 1] * np.uint32(oh._PRIMES[1]))
               ^ (c[:, 2] * np.uint32(oh._PRIMES[2]))) & np.uint32(T - 1)
    return np.minimum(idx, np.uint32(T - 1))


def test_uint32_hash_equals_int64_form():
    """Every level of ngp_hash_s05: the 64 corners of {0, 1, res - 1,
    res}^3 and 20,000 random corners in [0, res]^3 index alike in uint32
    and in the plain path's int64 (products masked to 32 bits); the
    products do wrap (some exceed 2^32)."""
    cfg = _bench_hash_cfg()
    T = cfg.table_size
    assert (cfg.n_levels, T, cfg.n_features) == (16, 2 ** 19, 2)
    rng = np.random.RandomState(0)
    wrapped = False
    for res in cfg.resolutions:
        edge = np.array([0, 1, res - 1, res])
        c = np.stack(np.meshgrid(edge, edge, edge, indexing="ij"),
                     -1).reshape(-1, 3)
        c = np.concatenate([c, rng.randint(0, res + 1, (20000, 3))])
        dense = torch.tensor([(res + 1) ** 3 <= T])
        want = oh._corner_indices(torch.as_tensor(c, dtype=torch.int64)[None],
                                  dense, torch.tensor([res]), T)[0].numpy()
        np.testing.assert_array_equal(_uint32_index(c, res, T), want)
        wrapped |= bool((c[:, 1].astype(np.int64) * oh._PRIMES[1]
                         >= 2 ** 32).any())
    assert wrapped


def _points(n, res, seed=0):
    """n points in [0, 1]^3: 0, 1 and cell faces of the first level
    (k / res), then uniform ones."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3).astype(np.float32)
    special = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5],
                        [1 / res, 2 / res, 3 / res]], np.float32)
    k = min(n, len(special))
    x[:k] = special[:k]
    return torch.as_tensor(x)


CFGS = {
    "mixed": dict(n_levels=4, log2_hashmap_size=10, base_resolution=4,
                  per_level_scale=2.0),
    "dense_only": dict(n_levels=3, log2_hashmap_size=12, base_resolution=4,
                       per_level_scale=1.5),
    "hashed_only": dict(n_levels=3, log2_hashmap_size=10,
                        base_resolution=32, per_level_scale=1.5),
}


def _cfg(name, **kw):
    return te.HashGridConfig(**CFGS[name], **kw)


def _table(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((cfg.n_levels, cfg.table_size, cfg.n_features),
                       generator=g)


def test_cfgs_cover_dense_and_hashed_levels():
    for name, want in (("mixed", {True, False}), ("dense_only", {True}),
                       ("hashed_only", {False})):
        cfg = _cfg(name)
        assert {(r + 1) ** 3 <= cfg.table_size
                for r in cfg.resolutions} == want, name


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_plain_encode_equals_hash_encode(name, dtype):
    """hash_grid_encode_plain on the gather dtype's table is hash_encode's
    plain path, bit for bit."""
    cfg = _cfg(name, table_dtype=dtype)
    table, x = _table(cfg), _points(300, cfg.base_resolution)
    want = te.hash_encode(table, x, cfg)
    got = hg.hash_grid_encode_plain(table.to(getattr(torch, dtype)), x,
                                    cfg.resolutions)
    assert got.shape == (300, cfg.out_dim)
    assert torch.equal(got, want)


@pytest.mark.parametrize("F", [1, 4, 8])
def test_plain_encode_equals_hash_encode_other_widths(F):
    """Widths the kernels have no instance for: the plain arithmetic on
    the gather dtype's table is hash_encode's CPU path bit for bit, and
    the wrappers, plain versions included, refuse such a table."""
    cfg = _cfg("mixed", n_features=F)
    table, x = _table(cfg), _points(200, cfg.base_resolution, seed=4)
    tab = table.to(torch.bfloat16)
    assert torch.equal(oh.encode(tab, x, cfg.resolutions, "bfloat16"),
                       te.hash_encode(table, x, cfg))
    for fn in (hg.hash_grid_encode, hg.hash_grid_encode_plain):
        with pytest.raises(ValueError):
            fn(tab, x, cfg.resolutions)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_plain_grads_match_autograd(name):
    """hash_grid_grads_plain against autograd through hash_encode's plain
    path: the table gradient rtol 1e-6; dx, sums of terms of either sign
    in another order, within 1e-5 of its largest entry."""
    cfg = _cfg(name)
    table = _table(cfg).requires_grad_(True)
    x = _points(257, cfg.base_resolution, seed=1).requires_grad_(True)
    g = torch.randn((257, cfg.out_dim), generator=torch.Generator()
                    .manual_seed(2))
    (te.hash_encode(table, x, cfg) * g).sum().backward()
    dt, dx = hg.hash_grid_grads_plain(
        g, x.detach(), table.detach().to(torch.bfloat16), cfg.resolutions,
        tuple(table.shape), table_grad=True, x_grad=True)
    torch.testing.assert_close(dt, table.grad, rtol=1e-6, atol=1e-12)
    torch.testing.assert_close(dx, x.grad, rtol=0,
                               atol=1e-5 * float(x.grad.abs().max()))
    dt_only, none = hg.hash_grid_grads_plain(
        g, x.detach(), None, cfg.resolutions, tuple(table.shape))
    assert none is None and torch.equal(dt_only, dt)


def test_plain_corners_at_faces_and_bounds():
    """x at 0, 1 and on cell faces: the low corner within [0, res - 1],
    frac within [0, 1] (1 at x = 1), weights summing to 1, every index in
    [0, T)."""
    cfg = _cfg("mixed")
    x = _points(64, cfg.base_resolution, seed=3)
    idx, w, frac = oh.corners(x, cfg.resolutions, cfg.table_size)
    assert idx.shape == w.shape == (cfg.n_levels, 8, 64)
    assert int(idx.min()) >= 0 and int(idx.max()) < cfg.table_size
    assert float(frac.min()) >= 0.0 and float(frac.max()) <= 1.0
    assert bool((frac[:, 1] == 1.0).all())                 # x = 1
    assert bool((frac[:, 0] == 0.0).all())                 # x = 0
    torch.testing.assert_close(w.sum(1), torch.ones(cfg.n_levels, 64))
    idx32, w2 = hg.hash_grid_corners_plain(x, cfg.resolutions,
                                           cfg.table_size)
    assert idx32.dtype == torch.int32 and torch.equal(idx32.long(), idx)
    assert torch.equal(w2, w)


def test_wrappers_take_plain_versions_on_cpu():
    cfg = _cfg("mixed")
    tab = _table(cfg).to(torch.bfloat16)
    x = _points(33, cfg.base_resolution)
    g = torch.randn(33, cfg.out_dim)
    before = (hg.hash_grid_encode.launches, hg.hash_grid_grads.launches,
              hg.hash_grid_corners.launches)
    res, shape = cfg.resolutions, tuple(tab.shape)
    assert torch.equal(hg.hash_grid_encode(tab, x, res),
                       hg.hash_grid_encode_plain(tab, x, res))
    for a, b in zip(hg.hash_grid_grads(g, x, tab, res, shape, True, True),
                    hg.hash_grid_grads_plain(g, x, tab, res, shape, True,
                                             True)):
        assert torch.equal(a, b)
    for a, b in zip(hg.hash_grid_corners(x, res, cfg.table_size),
                    hg.hash_grid_corners_plain(x, res, cfg.table_size)):
        assert torch.equal(a, b)
    assert (hg.hash_grid_encode.launches, hg.hash_grid_grads.launches,
            hg.hash_grid_corners.launches) == before
    assert hg.hash_grid_encode_plain(tab, x[:0], res).shape == (
        0, cfg.out_dim)


def test_fused_path_is_not_taken_on_cpu():
    """CPU tensors never take the kernels: a traced hash_encode launches
    nothing and counts no enc_fused_points."""
    from google_nerf_tpu_torch.utils import logging as plog
    cfg = _cfg("mixed")
    table, x = _table(cfg), _points(40, 4)
    launches = hg.hash_grid_encode.launches
    before = plog.counters().get("enc_fused_points", 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        te.hash_encode(table, x, cfg)
    assert plog.counters().get("enc_fused_points", 0) == before
    assert hg.hash_grid_encode.launches == launches


@pytest.mark.parametrize("bad", ["x_f64", "x_2d", "x_noncontig", "f3",
                                 "f4", "f16_tab", "res_zero", "res_len",
                                 "tab_2d", "g_shape"])
def test_wrappers_refuse_bad_inputs(bad):
    cfg = _cfg("mixed")
    tab = _table(cfg).to(torch.bfloat16)
    x = _points(10, 4)
    g = torch.randn(10, cfg.out_dim)
    res, T = cfg.resolutions, cfg.table_size
    if bad == "x_f64":
        x = x.double()
    elif bad == "x_2d":
        x = x[:, :2].contiguous()
    elif bad == "x_noncontig":
        x = torch.cat([x, x], 1)[:, ::2]
    elif bad in ("f3", "f4"):
        tab = torch.zeros((len(res), T, int(bad[1])), dtype=torch.bfloat16)
    elif bad == "f16_tab":
        tab = tab.half()
    elif bad == "res_zero":
        res = (0,) + tuple(res[1:])
    elif bad == "res_len":
        res = tuple(res[:-1])
    elif bad == "tab_2d":
        tab = tab.reshape(len(res) * T, -1)
    elif bad == "g_shape":
        g = g[:, :-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        if bad == "g_shape":
            hg.hash_grid_grads(g, x, tab, res, tuple(tab.shape), True, True)
        else:
            hg.hash_grid_encode(tab, x, res)
