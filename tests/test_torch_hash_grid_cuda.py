"""Card-only tests of the hash-grid kernels (csrc/hash_grid.cu through
ops/cuda/hash_grid.py) against their plain versions.  This file imports
no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_hash_grid_cuda.py

Without a card every test here skips.  Shapes: the benchmark's hash
field (16 levels x 2^19 x 2, rows gathered in bf16 and in f32), a field
of dense levels only and one of hashed levels only; 0, 1, an odd number
and 2^18 points, among them x at 0, at 1 and on cell faces.  Bounds:
  * corners: every index equal and every weight bit for bit;
  * features: bit for bit (the kernel adds the 8 corners in the plain
    version's order);
  * the table gradient: atomic f32 sums within chip_smoke.py's P3 bound
    (P3_SUM_C sqrt(n) 2^-24 x the sum of |payload| of a row of n
    payloads) of the float64 sum of the plain version's payloads;
  * dx: atomic sums over levels of terms of either sign, within 1e-5 of
    its largest entry.
"""
import pytest
import torch

from google_nerf_tpu_torch.models import encoders as te
from google_nerf_tpu_torch.ops import hash_grid as oh
from google_nerf_tpu_torch.ops.cuda import hash_grid as hg

CFGS = {
    "ngp_hash_s05": lambda: te.hashgrid_config_for_scale(
        0.5, num_levels=16, n_features=2, log2_hashmap_size=19),
    "dense_only": lambda: te.HashGridConfig(
        n_levels=3, log2_hashmap_size=12, base_resolution=4,
        per_level_scale=1.5),
    "hashed_only": lambda: te.HashGridConfig(
        n_levels=3, log2_hashmap_size=10, base_resolution=32,
        per_level_scale=1.5),
}
NS = (0, 1, 1001, 2 ** 18)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run there only")
    return torch.device("cuda")


def _points(n, res, dev, seed=0):
    """n points in [0, 1]^3, the first at 0, 1 and on cell faces of the
    first level and of a finer one; past 1024 points, the second half
    lies in runs of 64 along straight lines, as a ray's samples do (so
    the lanes of a warp share corners)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 3), generator=g, device=dev)
    if n > 1024:
        m = (n - n // 2) // 64 * 64
        o = torch.rand((m // 64, 1, 3), generator=g, device=dev)
        d = torch.randn((m // 64, 1, 3), generator=g, device=dev) * 0.01
        t = torch.arange(64, device=dev, dtype=torch.float32)[None, :, None]
        x[n - m:] = (o + t * d).clamp(0, 1).reshape(m, 3)
    special = torch.tensor([[0, 0, 0], [1, 1, 1], [0, 1, 0.5],
                            [1 / res, 2 / res, 3 / res],
                            [5 / (4 * res), 0.5, 7 / (4 * res)]],
                           device=dev)[:n]
    x[:special.shape[0]] = special
    return x.contiguous()


def _table(cfg, dev, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return scale * torch.randn((cfg.n_levels, cfg.table_size,
                                cfg.n_features), generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_cuda_corners_equal_plain(name, n):
    dev = _card()
    cfg = CFGS[name]()
    x = _points(n, cfg.base_resolution, dev)
    before = hg.hash_grid_corners.launches
    idx, w = hg.hash_grid_corners(x, cfg.resolutions, cfg.table_size)
    torch.cuda.synchronize()
    assert hg.hash_grid_corners.launches == before + (n > 0)
    pidx, pw = hg.hash_grid_corners_plain(x, cfg.resolutions, cfg.table_size)
    assert torch.equal(idx, pidx)
    assert torch.equal(w, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("gather", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_cuda_encode_matches_plain(name, gather, n):
    dev = _card()
    cfg = CFGS[name]()
    tab = _table(cfg, dev).to(gather)
    x = _points(n, cfg.base_resolution, dev, seed=1)
    before = hg.hash_grid_encode.launches
    got = hg.hash_grid_encode(tab, x, cfg.resolutions)
    torch.cuda.synchronize()
    assert hg.hash_grid_encode.launches == before + (n > 0)
    want = hg.hash_grid_encode_plain(tab, x, cfg.resolutions)
    assert got.shape == want.shape == (n, cfg.out_dim)
    assert torch.equal(got, want)


def _assert_table_grad_within_p3_bound(dt, g, x, cfg):
    """dt against the float64 per-row sums of the plain version's payloads
    (w_c * g) within chip_smoke's P3 bound; returns the most payloads a
    row took."""
    from chip_smoke import P3_SUM_BOUND
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    n, dev = x.shape[0], x.device
    idx, w, _ = oh.corners(x, cfg.resolutions, T)
    rows = (idx + torch.arange(L, device=dev)[:, None, None] * T).reshape(-1)
    payload = (w[..., None] * g.reshape(n, L, F).permute(1, 0, 2)[:, None]
               ).reshape(-1, F).double()

    def sum64(v):
        return torch.zeros((L * T, F), dtype=torch.float64,
                           device=dev).index_add_(0, rows, v)
    d = (dt.reshape(L * T, F).double() - sum64(payload)).abs()
    terms = torch.bincount(rows, minlength=L * T).double()[:, None]
    assert bool((d <= P3_SUM_BOUND(terms) * sum64(payload.abs())).all())
    return int(terms.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_cuda_table_grad_within_p3_bound(name, n):
    """The atomic table gradient against the float64 per-row sums of the
    plain version's payloads (w_c * g), including the dense levels' rows
    of hundreds to thousands of payloads, which the warps pre-sum."""
    dev = _card()
    cfg = CFGS[name]()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    x = _points(n, cfg.base_resolution, dev, seed=2)
    g = torch.randn((n, L * F), generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
    before = hg.hash_grid_grads.launches
    dt, dx = hg.hash_grid_grads(g, x, None, cfg.resolutions, (L, T, F))
    torch.cuda.synchronize()
    assert dx is None and hg.hash_grid_grads.launches == before + (n > 0)
    most = _assert_table_grad_within_p3_bound(dt, g, x, cfg)
    if n == 2 ** 18 and name != "hashed_only":
        assert most >= 400                    # crowded dense rows


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_cuda_dx_matches_plain(name, gather):
    dev = _card()
    cfg = CFGS[name]()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    tab = _table(cfg, dev, seed=4).to(gather)
    x = _points(1001, cfg.base_resolution, dev, seed=5)
    g = torch.randn((1001, L * F), generator=torch.Generator(device=dev)
                    .manual_seed(6), device=dev)
    dt, dx = hg.hash_grid_grads(g, x, tab, cfg.resolutions, (L, T, F),
                                table_grad=False, x_grad=True)
    torch.cuda.synchronize()
    assert dt is None
    _, want = hg.hash_grid_grads_plain(g, x, tab, cfg.resolutions,
                                       (L, T, F), False, True)
    torch.testing.assert_close(dx, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["bfloat16", "float32"])
def test_cuda_hash_encode_takes_the_kernels(table_dtype):
    """hash_encode on CUDA tensors: one forward and one backward launch,
    `enc_fused_points` counting N under a profiler, the features of the
    plain path bit for bit and its gradients of the table and of x; a
    table of 3 features, which the kernels have no instance for, is
    refused with nothing launched."""
    from google_nerf_tpu_torch.utils import logging as plog
    dev = _card()
    cfg = te.hashgrid_config_for_scale(0.5, num_levels=16,
                                       log2_hashmap_size=19,
                                       table_dtype=table_dtype)
    n = 4097
    table = _table(cfg, dev, seed=7, scale=1e-2).requires_grad_(True)
    x = _points(n, cfg.base_resolution, dev, seed=8).requires_grad_(True)
    g = torch.randn((n, cfg.out_dim), generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev)
    launches = (hg.hash_grid_encode.launches, hg.hash_grid_grads.launches)
    counted = plog.counters().get("enc_fused_points", 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = te.hash_encode(table, x, cfg)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert plog.counters()["enc_fused_points"] == counted + n
    assert (hg.hash_grid_encode.launches, hg.hash_grid_grads.launches) == (
        launches[0] + 1, launches[1] + 1)
    tab = table.detach().to(getattr(torch, table_dtype))
    want = hg.hash_grid_encode_plain(tab, x.detach(), cfg.resolutions)
    assert torch.equal(out.detach(), want)
    dt, dx = hg.hash_grid_grads_plain(g, x.detach(), tab, cfg.resolutions,
                                      tuple(table.shape), True, True)
    torch.testing.assert_close(table.grad, dt, rtol=1e-5,
                               atol=1e-6 * float(dt.abs().max()))
    torch.testing.assert_close(x.grad, dx, rtol=0,
                               atol=1e-5 * float(dx.abs().max()))

    cfg3 = te.HashGridConfig(n_levels=2, n_features=3, log2_hashmap_size=10)
    t3 = _table(cfg3, dev)
    launches = hg.hash_grid_encode.launches
    with pytest.raises(ValueError):
        te.hash_encode(t3, x.detach(), cfg3)
    assert hg.hash_grid_encode.launches == launches


@pytest.mark.cuda
def test_cuda_wrappers_refuse_misaligned_tables():
    dev = _card()
    cfg = CFGS["dense_only"]()
    buf = torch.zeros(cfg.n_levels * cfg.table_size * 2 + 1, device=dev)
    tab = buf[1:].view(cfg.n_levels, cfg.table_size, 2)
    with pytest.raises(ValueError):
        hg.hash_grid_encode(tab, _points(8, 4, dev), cfg.resolutions)
