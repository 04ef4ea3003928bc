"""Card-only tests of the PyTorch port's CUDA kernels K1-K5 and P1-P5, and
the toy kernel inputs the CPU tests share.  This file imports no JAX, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports JAX, hence --noconftest).  Without a card
every test here skips.  Against the numpy golden the tolerances are
those of tests/test_render_brick_mxu.py: tau atol/rtol 5e-2, rgb and
depth atol 3e-2, n_pairs exact (the golden rounds nothing to bf16).  A
kernel against its plain version, and the card's frame against the
CPU's, compute one function with the same roundings: atol 1e-4 and
equal n_pairs and counters."""
import numpy as np
import pytest
import torch

from google_nerf_tpu_torch.ops.cuda import brick_field as tbf


def _toy_inputs(seed=0, T=2, Lp=3, n_blocks=4, sigma_scale=1.0, Bk=8):
    """Random bricks laid along +z in [-0.5, 0.5]^3 with rays marching
    through them from z=-1 (tests/test_render_brick_mxu.py's inputs, MLP
    weights drawn with numpy).  The voxel grid is V = 4 * Bk, so Bk=4
    bricks span the same space as Bk=8 ones (at a fixed V=32 they would
    miss every ray)."""
    rng = np.random.RandomState(seed)
    V, s = 4 * Bk, 0.5
    vox = Bk ** 3
    blk = np.stack([np.full(n_blocks, 1), np.full(n_blocks, 1),
                    np.arange(n_blocks)], -1)
    lo = (blk * Bk / V * 2.0 - 1.0) * s
    hi = ((blk + 1) * Bk / V * 2.0 - 1.0) * s
    pool3 = rng.randn(n_blocks, vox, 128).astype(np.float32) * 0.1
    pool3[..., 0::16] = rng.randn(n_blocks, vox, 8) * sigma_scale
    order = np.arange(n_blocks)
    pool_blk = np.tile(order[:Lp], T).astype(np.int32)
    nslots = np.full(T, Lp, np.int32)
    nslots[0] = Lp - 1                 # tile 0 has one pad slot at its tail
    meta = np.zeros((T * Lp, 8), np.float32)
    for t in range(T):
        for l in range(Lp):
            meta[t * Lp + l, 0:3] = lo[order[l]]
            meta[t * Lp + l, 3:6] = hi[order[l]]
    o = np.concatenate([
        np.stack([np.full(64, -0.3 + 0.6 * t), np.zeros(64),
                  np.full(64, -1.0)], -1) for t in range(T)])
    d = np.stack([rng.uniform(-0.2, 0.2, T * 64),
                  rng.uniform(-0.2, 0.2, T * 64),
                  np.ones(T * 64)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t1 = np.full(T * 64, 0.3, np.float32)
    t2 = np.full(T * 64, 2.5, np.float32)
    rays = np.concatenate([o, d, t1[:, None], t2[:, None]],
                          -1).astype(np.float32)
    sh = rng.randn(T * 64, 16).astype(np.float32) * 0.3
    ws = [rng.uniform(-1, 1, (a, b)).astype(np.float32) * (6.0 / a) ** 0.5
          for a, b in ((32, 64), (64, 64), (64, 3))]
    kw = dict(S=(9 if Bk == 8 else 5), dt=float(np.sqrt(3) / 128),
              tau_max=float(-np.log(1e-2)), Bk=Bk)
    return (pool_blk, meta, rays, sh, pool3, *ws), nslots, kw


def _dense_brick_inputs(S=None, n_tiles=4, device="cpu", rgba=False):
    """The seeded serving-width bricks and rays of chip_smoke.py phase 2
    (tools/brick_inputs.py: Bk=8 bf16 pool, 32-slot lists) at toy size,
    sigma raised so that rays saturate after a few bricks: (args, nslots,
    Lp, keywords).  S: a window span longer than one field pass of the
    dense kernels, at a finer dt.  rgba: args are K5's (pool_blk, meta,
    rays, pre-shaded slabs), whose sigma lanes hold the row pool's sigma,
    raised alike."""
    from google_nerf_tpu_torch.tools.brick_inputs import serving_width_inputs
    args, slabs, nslots, Lp, kw = serving_width_inputs(n_tiles, 0, device)
    if rgba:
        raise_sigma = torch.tensor([2.0, 0.0, 0.0, 0.0],
                                   device=device).repeat(8)[:, None]
        args = args[:3] + [(slabs.float() + raise_sigma).to(torch.bfloat16)]
    else:
        raise_sigma = torch.tensor([2.0] + [0.0] * 15,
                                   device=device).repeat(8)
        args[4] = (args[4].float() + raise_sigma).to(torch.bfloat16)
    if S is not None:
        kw = dict(kw, S=S, dt=float(np.sqrt(3) / 4096))
    return args, nslots, Lp, kw


def _toy_rgba_pool(pool3):
    """(nb, vox, 128) feature pool -> (nb, 32, vox) rgba slabs with h0 =
    the sigma lane and seeded in-[0, 1] rgb (tests/test_render_brick_mxu
    .py's _toy_rgba_pool)."""
    rng = np.random.RandomState(7)
    nb, vox, _ = pool3.shape
    h0 = np.swapaxes(pool3[:, :, 0::16], 1, 2)          # (nb, 8, vox)
    rgb = rng.uniform(0.0, 1.0, (nb, 8, 3, vox)).astype(np.float32)
    return np.concatenate([h0[:, :, None, :], rgb], axis=2).reshape(
        nb, 32, vox)


def _dense_call(kernel, args, nslots, device="cpu", pool_dtype=None):
    """(wrapper, plain version, positional tensors, keywords) of K3 ("n"),
    K4 ("t", transposed pool) or K5 ("rgba", toy rgba slabs) on the toy
    inputs."""
    t = _torch(args, device)
    if kernel == "t":
        t[4] = t[4].transpose(1, 2).contiguous()
    elif kernel == "rgba":
        t = t[:3] + [torch.as_tensor(_toy_rgba_pool(args[4]), device=device)]
    if pool_dtype is not None:
        i = 3 if kernel == "rgba" else 4
        t[i] = t[i].to(pool_dtype)
    fns = {"n": (tbf.brick_field_tiles, tbf.brick_field_tiles_plain),
           "t": (tbf.brick_field_tiles_t, tbf.brick_field_tiles_t_plain),
           "rgba": (tbf.brick_field_tiles_rgba,
                    tbf.brick_field_tiles_rgba_plain)}[kernel]
    return (*fns, t, dict(nslots=torch.as_tensor(nslots, device=device)))


def _torch(args, device="cpu"):
    return [torch.as_tensor(x, device=device) for x in args]


def _assert_matches(got, want):
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], atol=3e-2)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])


def _assert_same(got, want):
    """Kernel against plain version: tau, rgb, depth within 1e-4."""
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])


def _worklist(T, Lp, nslots, P):
    """Tile-major worklist over T tiles' P-slot groups, followed by two
    pad steps that repeat the last tile (wn == 0)."""
    wt, wl, wn, wf = [], [], [], []
    for t in range(T):
        for g in range(-(-int(nslots[t]) // P)):
            wt.append(t)
            wl.append(t * Lp + g * P)
            wn.append(min(P, int(nslots[t]) - g * P))
            wf.append(int(g == 0))
    for _ in range(2):
        wt.append(wt[-1])
        wl.append(wl[-1])
        wn.append(0)
        wf.append(0)
    return [np.asarray(x, np.int32) for x in (wt, wl, wn, wf)]


def _carry_inputs(device="cpu", rgba=False, S=None):
    """Six dense tiles (_dense_brick_inputs; rgba: K5's, S: long windows)
    and a seeded init carry: tau partly spent on most rays, at or past
    tau_max on some (on all of tile 5's, whose block returns at once), and
    just below it on others, whose gate the first live slot of a batch
    closes: (args, nslots, Lp, keywords, init)."""
    args, nslots, Lp, kw = _dense_brick_inputs(S, n_tiles=6, device=device,
                                               rgba=rgba)
    g = torch.Generator().manual_seed(11)
    tau_max, n = kw["tau_max"], 6 * 64
    init = torch.zeros(n, 8)
    init[:, 0] = torch.rand(n, generator=g) * 0.5 * tau_max
    init[:, 1:5] = torch.rand(n, 4, generator=g) * 0.3
    init[:, 5] = torch.randint(0, 4, (n,), generator=g).float()
    init[:, 6:8] = torch.rand(n, 2, generator=g)
    init[::5, 0] = tau_max + 0.5
    init[2::5, 0] = tau_max - 0.05
    init[5 * 64:, 0] = tau_max
    return args, nslots, Lp, kw, init.to(device)


def _split_worklist(nslots, Lp, P, device="cpu"):
    """Tile-major worklist over tiles 0, 1, 4 and 5 of _carry_inputs in
    P-aligned steps: tile 1 takes two steps, the first listing fewer than
    P rows, so its rows are not contiguous; tiles 2 and 3 have no step;
    two pad steps repeat the last tile."""
    steps = [(1, Lp, P // 2 - 1, 1), (1, Lp + P, 5, 0)]   # (wt, wl, wn, wf)
    for t in (0, 4, 5):
        n = int(nslots[t])
        steps += [(t, t * Lp + g * P, min(P, n - g * P), int(g == 0))
                  for g in range(-(-n // P))]
    steps.sort(key=lambda s: s[0])                        # tile-major
    steps += [steps[-1][:2] + (0, 0)] * 2
    return [torch.tensor(x, dtype=torch.int32, device=device)
            for x in zip(*steps)]


# ------------------------------------------------------------ card only

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run there only")
    return torch.device("cuda")


def _card_call(kernel, Bk, dev, S=None):
    """(wrapper, plain, tensors, keywords) of any kernel on the toy
    inputs, on the card, bf16 pool."""
    args, nslots, kw = _toy_inputs(Lp=4, Bk=Bk)
    if S is not None:
        # long windows: rays cross a brick in ~74 samples at this dt, so S
        # truncates them and the kernel composites S > 64 samples per ray
        kw = dict(kw, S=S, dt=float(np.sqrt(3) / 512))
    if kernel in ("n", "t", "rgba"):
        fn, plain, t, extra = _dense_call(kernel, args, nslots, dev,
                                          torch.bfloat16)
        return fn, plain, t, extra, kw, nslots, args
    t = _torch(args, dev)
    t[4] = t[4].to(torch.bfloat16)
    if kernel == "tp":
        fn, plain = tbf.brick_field_tiles_tp, tbf.brick_field_tiles_tp_plain
        extra = dict(nslots=torch.as_tensor(nslots, device=dev), P=2)
    else:
        fn, plain = tbf.brick_field_tiles_wl, tbf.brick_field_tiles_wl_plain
        t += _torch(_worklist(2, 4, nslots, 2), dev)
        extra = dict(P=2)
    return fn, plain, t, extra, kw, nslots, args


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,Bk,carry,S", [
    ("tp", 8, False, None), ("wl", 8, False, None), ("tp", 4, False, None),
    ("wl", 4, False, None), ("tp", 8, True, None), ("wl", 8, True, None),
    ("n", 8, False, None), ("n", 4, False, None), ("t", 8, False, None),
    ("t", 4, False, None), ("rgba", 8, False, None),
    ("rgba", 4, False, None), ("rgba", 8, True, None),
    ("rgba", 4, True, None), ("tp", 8, True, 65),
    ("n", 8, False, 65), ("t", 8, False, 65), ("rgba", 8, True, 65)])
def test_cuda_kernel_matches_plain(kernel, Bk, carry, S):
    """Each kernel against its plain version on the card; `carry` starts
    from a nonzero init with some rays already saturated (K1, K2, K5);
    S=65 composites windows longer than one pass of the kernel."""
    dev = _card()
    fn, plain, t, extra, kw, _, _ = _card_call(kernel, Bk, dev, S)
    if carry:
        init = torch.zeros((128, 8), device=dev)
        init[:, 0] = torch.linspace(0.0, 6.0, 128, device=dev)
        init[:, 1:5] = 0.2
        kw = dict(kw, init=init)
    before = fn.launches
    got = fn(*t, **extra, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*t, **extra, **kw)
    _assert_same(got.cpu().numpy(), want.cpu().numpy())
    assert float(got[:, 5].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,Bk", [("tp", 8), ("wl", 8), ("tp", 4),
                                       ("wl", 4), ("n", 8), ("n", 4),
                                       ("t", 8), ("t", 4), ("rgba", 8),
                                       ("rgba", 4)])
def test_cuda_kernel_matches_golden(kernel, Bk):
    """Each kernel against the port's numpy golden, the reference that
    needs no JAX, at the JAX kernel tests' tolerances."""
    dev = _card()
    fn, _, t, extra, kw, nslots, args = _card_call(kernel, Bk, dev)
    if kernel == "rgba":
        want = tbf.brick_field_rgba_reference(
            *args[:3], _toy_rgba_pool(args[4]), nslots=nslots, inv2s=1.0,
            V=32, **kw)
    else:
        want = tbf.brick_field_tiles_reference(*args, nslots=nslots,
                                               inv2s=1.0, V=32, **kw)
    _assert_matches(fn(*t, **extra, **kw).cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["n", "t", "rgba"])
@pytest.mark.parametrize("Lcall,S", [(5, None), (12, None), (32, None),
                                     (12, 65)])
def test_cuda_dense_batches_match_plain(layout, Lcall, S):
    """K3, K4 and K5, which take 8 list slots a batch, on dense bricks
    where the gate closes inside a batch (tests/test_torch_brick_field
    _batched.py counts it on these inputs): Lcall below, above and a
    multiple of 8, one listed tile whose rays miss every brick, one with
    no slot, and an unlisted tile whose `out` row is kept; S=65 composites
    windows over several passes.  K5 carries: its init is the `out` rows,
    which the tiles with no live hit keep."""
    dev = _card()
    rgba = layout == "rgba"
    args, nslots, Lp, kw = _dense_brick_inputs(S, n_tiles=6, device=dev,
                                               rgba=rgba)
    if layout == "t":
        args[4] = args[4].transpose(1, 2).contiguous()
    args[2] = args[2].clone()
    args[2][64:128, 0] += 1.0                 # tile 1 misses every brick
    tid = torch.tensor([0, 1, 2, 4, 5], device=dev)        # tile 3 unlisted
    ns = nslots[tid].clone()
    ns[2] = 0                                 # tile 2 has no slot
    fn, plain = {
        "n": (tbf.brick_field_tiles, tbf.brick_field_tiles_plain),
        "t": (tbf.brick_field_tiles_t, tbf.brick_field_tiles_t_plain),
        "rgba": (tbf.brick_field_tiles_rgba,
                 tbf.brick_field_tiles_rgba_plain)}[layout]
    call = dict(tid=tid, lbase=tid * Lp, nslots=ns, Lcall=Lcall, **kw)
    out = torch.full((6 * 64, 8), 0.25, device=dev)
    if rgba:
        call["init"] = out
    before = fn.launches
    got = fn(*args, out=out.clone(), **call)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, out=out.clone(), **call)
    _assert_same(got.cpu().numpy(), want.cpu().numpy())
    assert bool((got[192:256] == 0.25).all())
    assert bool((got[64:192] == (0.25 if rgba else 0)).all())
    tau = got[got[:, 5] > 0, 0]               # rays with a live hit
    assert bool((tau >= kw["tau_max"]).any())
    assert not bool((tau >= kw["tau_max"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,P,Lcall", [
    ("tp", 8, 16), ("tp", 16, 32), ("tp", 4, 12), ("wl", 8, 0),
    ("wl", 16, 0), ("rgba", None, 12), ("rgba", None, 32)])
def test_cuda_carry_matches_plain(kernel, P, Lcall):
    """K2, K1 and K5 from a carry on dense bricks (tests/test_torch_brick
    _field_batched.py holds their batched order to the plain versions bit
    for bit on these inputs): rays saturated on entry, a gate that a
    batch's first slot closes, a tile with no slot (K2, K5) or no step
    (K1), an unlisted tile, a saturated tile whose block returns at once,
    K1's split steps and pad steps, K2 and K5 at an Lcall that 8 does not
    divide.  Kernel against plain within 1e-4, n_pairs exact; the rows of
    tiles 2, 3 and 5 and columns 6-7 keep init bit for bit."""
    dev = _card()
    args, nslots, Lp, kw, init = _carry_inputs(dev, rgba=kernel == "rgba")
    if kernel in ("tp", "rgba"):
        fn, plain = ((tbf.brick_field_tiles_tp, tbf.brick_field_tiles_tp_plain)
                     if kernel == "tp" else (tbf.brick_field_tiles_rgba,
                                             tbf.brick_field_tiles_rgba_plain))
        tid = torch.tensor([0, 1, 2, 4, 5], device=dev)
        ns = nslots[tid].clone()
        ns[2] = 0
        a, call = args, dict(tid=tid, lbase=tid * Lp, nslots=ns, Lcall=Lcall)
    else:
        fn, plain = tbf.brick_field_tiles_wl, tbf.brick_field_tiles_wl_plain
        a, call = args + _split_worklist(nslots, Lp, P, dev), {}
    if P is not None:
        call["P"] = P
    before = fn.launches
    got = fn(*a, init=init, **call, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*a, init=init, **call, **kw)
    _assert_same(got.cpu().numpy(), want.cpu().numpy())
    assert torch.equal(got[2 * 64:4 * 64], init[2 * 64:4 * 64])
    assert torch.equal(got[5 * 64:], init[5 * 64:])
    assert torch.equal(got[:, 6:8], init[:, 6:8])
    assert bool((got[:, 5] > init[:, 5]).any())


@pytest.mark.cuda
def test_cuda_tp_contract_fails_loudly():
    """A misaligned lbase or a repeated tid on CUDA tensors trips a
    device-side assert (no host sync in the wrapper): the process fails
    at its next sync.  Run in a child, since the assert ends the CUDA
    context."""
    import subprocess
    import sys
    from pathlib import Path
    _card()
    root = Path(__file__).resolve().parents[1]
    body = ("import sys, torch\n"
            "sys.path[:0] = [{root!r}, {tests!r}]\n"
            "from test_torch_cuda import _torch, _toy_inputs\n"
            "from google_nerf_tpu_torch.ops.cuda import brick_field as b\n"
            "args, ns, kw = _toy_inputs(Lp=4)\n"
            "t = _torch(args, 'cuda'); t[4] = t[4].to(torch.bfloat16)\n"
            "b.brick_field_tiles_tp(*t, {bad}, Lcall=4, P=4, **kw)\n"
            "torch.cuda.synchronize()\n")
    for bad in ("lbase=torch.tensor([0, 2], device='cuda')",
                "tid=torch.tensor([1, 1], device='cuda')"):
        res = subprocess.run(
            [sys.executable, "-c", body.format(root=str(root), tests=str(
                root / "tests"), bad=bad)], capture_output=True, text=True,
            timeout=300)
        assert res.returncode != 0, bad
        assert "assert" in res.stderr.lower(), res.stderr[-2000:]


def _card_scene():
    """The 16x16 scene of tests/test_render_brick_mxu.py, built by the
    port on the CPU (seeded torch weights, full occupancy)."""
    from google_nerf_tpu_torch.core.rays import get_ray_directions, get_rays
    from google_nerf_tpu_torch.data.synthetic import _fibonacci_poses
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=16,
                    packed_log2_size=12, packed_levels=4)
    params = init_ngp(torch.Generator().manual_seed(0), cfg, device="cpu")
    params["packed_table"] *= 1e3
    bcfg = BakedConfig(voxel_res=32, block=8)
    baked = bake(params, cfg, torch.ones(1, 16, 16, 16, dtype=torch.bool),
                 bcfg, device="cpu")
    K = np.array([[16, 0, 8], [0, 16, 8], [0, 0, 1]], np.float32)
    o, d = get_rays(get_ray_directions(16, 16, K, device="cpu"),
                    torch.as_tensor(_fibonacci_poses(1, 1.2, 1000)[0]))
    return cfg, bcfg, baked, o, d


def _assert_frames_same(got, want):
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-4)
    for k in ("pairs_undrained", "trunc_tiles", "pairs_rendered",
              "dma_slots"):
        assert int(got[k]) == int(want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("wl_cap", [0, 1])
def test_cuda_frame_matches_cpu_frame(wl_cap):
    """The whole worklist frame on the card (K1, and K2 in the drain that
    wl_cap=1 forces) against the same frame on the CPU (plain versions),
    at the 16x16 setup of tests/test_render_brick_mxu.py."""
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    dev = _card()
    cfg, bcfg, baked, o, d = _card_scene()
    kw = dict(bcfg=bcfg, max_samples=64, T_threshold=1e-2, L=64,
              exact_cull=16, pbatch=2, drain_tiles=4, drain_L=64,
              drain_xc=32, segment_slots=8, wl_cap=wl_cap, kernel="wl")
    launches = (tbf.brick_field_tiles_wl.launches,
                tbf.brick_field_tiles_tp.launches)
    got = render_brick_mxu({k: (v.to(dev) if torch.is_tensor(v) else v)
                            for k, v in baked.items()}, cfg, o.to(dev),
                           d.to(dev), 16, 16, device=dev, **kw)
    torch.cuda.synchronize()
    want = render_brick_mxu(baked, cfg, o, d, 16, 16, device="cpu", **kw)
    _assert_frames_same(got, want)
    assert tbf.brick_field_tiles_wl.launches > launches[0]
    if wl_cap:
        assert tbf.brick_field_tiles_tp.launches > launches[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,extra", [
    ("n", dict(bands="auto", exact_cull=16, drain_xc=32)),
    ("t", dict(bands=((1, 16), (3, 8)), exact_cull=16, drain_xc=32)),
    ("tp", dict(pbatch=2, segment_slots=8, exact_cull=16, drain_xc=32)),
    ("rgba", dict(segment_slots=8)), ("n", dict(L=4))])
def test_cuda_dense_frame_matches_cpu_frame(kernel, extra):
    """The per-chunk frames on the card (K3, K4, K2, K5 and their drains)
    against the same frames on the CPU."""
    from google_nerf_tpu_torch.models.baked_rgba import \
        render_brick_mxu_rgba
    from google_nerf_tpu_torch.models.render_brick_mxu import \
        render_brick_mxu
    dev = _card()
    cfg, bcfg, baked, o, d = _card_scene()
    kw = dict(dict(bcfg=bcfg, max_samples=64, T_threshold=1e-2, L=64,
                   macro_tiles=0, drain_tiles=4, drain_L=64), **extra)
    fn = {"n": tbf.brick_field_tiles, "t": tbf.brick_field_tiles_t,
          "tp": tbf.brick_field_tiles_tp,
          "rgba": tbf.brick_field_tiles_rgba}[kernel]
    render = render_brick_mxu_rgba if kernel == "rgba" else render_brick_mxu
    if kernel != "rgba":
        kw["kernel"] = kernel
    before = fn.launches
    got = render({k: (v.to(dev) if torch.is_tensor(v) else v)
                  for k, v in baked.items()}, cfg, o.to(dev), d.to(dev), 16,
                 16, device=dev, **kw)
    torch.cuda.synchronize()
    want = render(baked, cfg, o, d, 16, 16, device="cpu", **kw)
    _assert_frames_same(got, want)
    assert fn.launches > before


# -------------------------------------------- tool probes and the ladder

def _probe_launches():
    from google_nerf_tpu_torch.ops.cuda import probe
    return {"gather_rows_f32": probe.gather_rows.launches["float32"],
            "gather_rows_bf16": probe.gather_rows.launches["bfloat16"],
            "scatter_add_rows": probe.scatter_add_rows.launches,
            "gather_rows_bulk": probe.gather_rows_bulk.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [{}, dict(t=1000, n=12345, ns=999, nc=77)],
                         ids=["tool", "ragged"])
def test_cuda_probes_match_plain(sizes):
    """P1-P4 at tools/pallas_probe.py's sizes and at sizes no block
    divides: gathers bitwise, the atomic scatter within atol 1e-5; each
    call launches its kernel once."""
    from google_nerf_tpu_torch.tools import kernel_probe
    _card()
    for p in kernel_probe.probes("cuda", seed=3, **sizes):
        before = _probe_launches()
        got = p.fn(*p.args)
        torch.cuda.synchronize()
        after = _probe_launches()
        assert after[p.name] == before[p.name] + 1, p.name
        assert sum(after.values()) == sum(before.values()) + 1
        ok, err = p.agrees(got, p.plain(*p.args))
        assert ok, (p.name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_bytes", [16, 128, 512])
@pytest.mark.parametrize("nc", [1, 31, 32, 33, 77, 16384])
def test_cuda_bulk_gather_warp_tiles(nc, row_bytes, dtype):
    """P4 on full and ragged warp tiles (32 rows a warp) and rows of 16,
    128 and 512 bytes in f32 and bf16: bitwise the plain version's, one
    launch a call; through the C entry, the warps' bulk stores leave the
    rows of a larger output past the last gathered row untouched."""
    from google_nerf_tpu_torch.ops.cuda import probe
    _card()
    f = row_bytes // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device="cuda").manual_seed(nc + row_bytes)
    tab = torch.randn(1000, f, generator=g, device="cuda").to(dtype)
    idx = torch.randint(0, 1000, (nc,), generator=g, device="cuda",
                        dtype=torch.int32)
    before = probe.gather_rows_bulk.launches
    got = probe.gather_rows_bulk(tab, idx)
    torch.cuda.synchronize()
    assert probe.gather_rows_bulk.launches == before + 1
    assert torch.equal(got, probe.gather_rows_bulk_plain(tab, idx))
    out = torch.full((nc + 40, f), 7.0, dtype=dtype, device="cuda")
    probe._launch("probe_gather_rows_bulk", probe._ptr(tab), tab.shape[0],
                  row_bytes, probe._ptr(idx), nc, probe._ptr(out),
                  dev=out.device)
    torch.cuda.synchronize()
    assert torch.equal(out[:nc], got)
    assert bool((out[nc:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "vals_4B_off"])
@pytest.mark.parametrize("f", [1, 3, 4, 16, 32, 33])
def test_cuda_scatter_add_vector_and_scalar_words(f, offset):
    """P3 with rows of whole 16-byte words (F = 4, 16, 32), words cut
    short by F (1, 3, 33), and vals a contiguous view 4 bytes off a
    16-byte boundary (every word takes the scalar adds): within atol 1e-5
    of the plain version (~4 N(0,1) rows a table row), one launch."""
    from google_nerf_tpu_torch.ops.cuda import probe
    _card()
    ns, t = 4099, 1000
    g = torch.Generator(device="cuda").manual_seed(f)
    buf = torch.randn(ns * f + 4, generator=g, device="cuda")
    vals = buf[offset:offset + ns * f].view(ns, f)
    assert vals.is_contiguous()
    assert vals.data_ptr() % 16 == 4 * offset
    sidx = torch.randint(0, t, (ns,), generator=g, device="cuda",
                         dtype=torch.int32)
    before = probe.scatter_add_rows.launches
    got = probe.scatter_add_rows(sidx, vals, t)
    torch.cuda.synchronize()
    assert probe.scatter_add_rows.launches == before + 1
    assert float((got - probe.scatter_add_rows_plain(sidx, vals, t))
                 .abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_scatter_add_all_onto_one_row():
    """131,072 contributions of F = 32 all onto row 0 (16,384 float4
    reductions on each of its 8 words): kernel and plain version each
    within 1e-6 of the column's sum of |vals| of the f64 sum (an f32 sum
    of N(0,1) values in any order drifts by ~2^-24 of it, ~6e-8); every
    other row stays 0."""
    from google_nerf_tpu_torch.ops.cuda import probe
    _card()
    ns, f, t = 1 << 17, 32, 1 << 16
    g = torch.Generator(device="cuda").manual_seed(11)
    vals = torch.randn(ns, f, generator=g, device="cuda")
    sidx = torch.zeros(ns, dtype=torch.int32, device="cuda")
    exact = vals.double().sum(0)
    tol = 1e-6 * vals.double().abs().sum(0)
    for fn in (probe.scatter_add_rows, probe.scatter_add_rows_plain):
        got = fn(sidx, vals, t)
        assert bool(((got[0].double() - exact).abs() <= tol).all()), fn
        assert not bool(got[1:].any()), fn


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [0, 100])
def test_cuda_scatter_add_fills_reused_memory(ns):
    """The wrapper allocates with torch.empty and the C entry zeroes the
    output itself: a call right after a NaN-filled (T, F) tensor was freed
    gets that memory back and leaves no NaN in it, with few contributions
    (most rows only filled; one kernel launch) or none (the fill alone,
    no kernel launch)."""
    from google_nerf_tpu_torch.ops.cuda import probe
    _card()
    t, f = 1 << 16, 32
    g = torch.Generator(device="cuda").manual_seed(ns)
    vals = torch.randn(ns, f, generator=g, device="cuda")
    sidx = torch.randint(0, t, (ns,), generator=g, device="cuda",
                         dtype=torch.int32)
    nan = torch.full((t, f), float("nan"), device="cuda")
    ptr = nan.data_ptr()
    del nan
    before = probe.scatter_add_rows.launches
    got = probe.scatter_add_rows(sidx, vals, t)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr         # the freed block, reused
    assert probe.scatter_add_rows.launches == before + (ns > 0)
    assert not bool(got.isnan().any())
    assert float((got - probe.scatter_add_rows_plain(sidx, vals, t))
                 .abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_narrow_bf16_table_and_odd_rows():
    """A bf16 table with F=16 (32-byte rows) through both gathers; rows
    of 12 and 10 bytes, which no 16-byte word divides, raise without a
    launch."""
    from google_nerf_tpu_torch.ops.cuda import probe
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, 1000, (4099,), generator=g, device="cuda",
                        dtype=torch.int32)
    tab = torch.randn(1000, 16, generator=g, device="cuda").bfloat16()
    want = tab.index_select(0, idx)
    assert torch.equal(probe.gather_rows(tab, idx), want)
    assert torch.equal(probe.gather_rows_bulk(tab, idx), want)
    before = dict(probe.gather_rows.launches)
    for t in (torch.randn(1000, 3, generator=g, device="cuda"),
              torch.randn(1000, 5, generator=g, device="cuda").bfloat16()):
        with pytest.raises(ValueError, match="multiple of 16"):
            probe.gather_rows(t, idx)
    assert probe.gather_rows.launches == before


@pytest.mark.cuda
def test_cuda_bulk_gather_raises_on_rows_it_cannot_copy():
    """Rows of 12 bytes, of 1024 bytes, and a table 2 bytes off a 16-byte
    boundary raise; the wrapper never falls back to another path."""
    from google_nerf_tpu_torch.ops.cuda import probe
    _card()
    idx = torch.zeros(4, dtype=torch.int32, device="cuda")
    before = probe.gather_rows_bulk.launches
    for tab in (torch.zeros(8, 3, device="cuda"),
                torch.zeros(8, 256, device="cuda"),
                torch.zeros(65, dtype=torch.bfloat16,
                            device="cuda")[1:].view(8, 8)):
        with pytest.raises(ValueError):
            probe.gather_rows_bulk(tab, idx)
    assert probe.gather_rows_bulk.launches == before


@pytest.mark.cuda
def test_cuda_gather_index_out_of_range_asserts():
    """An index outside the table trips the kernel's device-side assert
    (run in a child: the assert ends the CUDA context)."""
    import subprocess
    import sys
    from pathlib import Path
    _card()
    root = Path(__file__).resolve().parents[1]
    body = ("import sys, torch\n"
            f"sys.path[:0] = [{str(root)!r}]\n"
            "from google_nerf_tpu_torch.ops.cuda import probe\n"
            "tab = torch.zeros(8, 32, device='cuda')\n"
            "idx = torch.tensor([0, 8], dtype=torch.int32, device='cuda')\n"
            "probe.gather_rows(tab, idx)\n"
            "torch.cuda.synchronize()\n")
    res = subprocess.run([sys.executable, "-c", body], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "assert" in res.stderr.lower(), res.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 18))
def test_cuda_ladder_rung_matches_plain(k):
    """Each rung of P5 on the JAX tool's operands: exact, or within rtol
    1e-5 for k13, k15 and k16; one launch each."""
    from google_nerf_tpu_torch.ops.cuda import ladder
    from google_nerf_tpu_torch.tools import kernel_ladder
    _card()
    before = ladder.rung.launches
    _, why = kernel_ladder.run_rung(k, ladder.operands("cuda"))
    assert why is None, why
    assert ladder.rung.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 7, 8, 17])
def test_cuda_grid_rungs_reset_their_ticket(k):
    """The rungs spread over a grid (k6, k7, k8, k17), each launched twice
    in a row on the tool's operands: both outputs equal the plain
    version's.  The last block of a launch, found by a ticket, writes the
    output and resets the ticket; a ticket left set would leave the second
    output unwritten (zero)."""
    from google_nerf_tpu_torch.ops.cuda import ladder
    _card()
    args = ladder.rung_operands(k, ladder.operands("cuda"))
    want = ladder.rung_plain(k, *args)
    before = ladder.rung.launches
    for _ in range(2):
        got = ladder.rung(k, *args)
        torch.cuda.synchronize()
        assert ladder.mismatch(k, got, want) is None
    assert ladder.rung.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 10])
def test_cuda_tensor_core_rungs_on_random_operands(k):
    """k8 and k10's mma.sync fragments on integer-valued random operands
    (every sum exact), where a misplaced element would show."""
    from google_nerf_tpu_torch.ops.cuda import ladder
    _card()
    g = torch.Generator(device="cuda").manual_seed(k)
    ops = ladder.operands("cuda")
    for name, shape in (("slabT", (128, 512)), ("w1", (64, 32))):
        ops[name] = torch.randint(-4, 5, shape, generator=g, device="cuda"
                                  ).to(torch.bfloat16)
    args = ladder.rung_operands(k, ops)
    got = ladder.rung(k, *args)
    assert ladder.mismatch(k, got, ladder.rung_plain(k, *args)) is None


# ------------------------------------------------ the training slice

def _encoder_inputs(device, n=5000, seed=0):
    from google_nerf_tpu_torch.ops.packed_hash import packed_config_for_scale
    cfg = packed_config_for_scale(0.5, n_levels=8, log2_table_size=12)
    g = torch.Generator().manual_seed(seed)
    table = (torch.rand((8, 4096, 16), generator=g) - 0.5) * 0.2
    x = torch.rand((n, 3), generator=g) * 0.98 + 0.01
    gy = torch.randn((n, 16), generator=g)
    return cfg, table.to(device), x.to(device), gy.to(device)


@pytest.mark.cuda
def test_cuda_packed_encoder_matches_cpu():
    """The encoder Function on the card (P2 forward, P3 table gradient)
    against its CPU run (the plain versions): forward bitwise, dtable
    within 1e-6 x each (row, column)'s sum of |payload|, dx within 1e-5;
    one P2 (bf16) and one P3 launch."""
    from google_nerf_tpu_torch.ops import packed_hash as ph
    from google_nerf_tpu_torch.ops.cuda import probe
    dev = _card()
    outs = {}
    for d in ("cpu", dev):
        cfg, table, x, gy = _encoder_inputs(d)
        table.requires_grad_(True)
        x.requires_grad_(True)
        before = (probe.gather_rows.launches["bfloat16"],
                  probe.scatter_add_rows.launches)
        y = ph.packed_hash_encode(table, x, cfg)
        (y * gy).sum().backward()
        after = (probe.gather_rows.launches["bfloat16"],
                 probe.scatter_add_rows.launches)
        outs[str(d)] = (y.detach().cpu(), table.grad.cpu(), x.grad.cpu())
        if d != "cpu":
            assert after == (before[0] + 1, before[1] + 1)
    (y0, t0, x0), (y1, t1, x1) = outs["cpu"], outs["cuda"]
    assert torch.equal(y0, y1)
    cfg, table, x, gy = _encoder_inputs("cpu")
    keys, frac = ph._cell_keys(x, cfg)
    w = ph._corner_weights(frac)
    gl = gy.reshape(-1, 8, 2).permute(1, 0, 2)
    pay = (w[..., None] * gl[..., None, :]).reshape(-1, 16).abs()
    mag = probe.scatter_add_rows_plain(ph._rows_index(keys, 4096), pay,
                                       8 * 4096).view(8, 4096, 16)
    assert ((t1 - t0).abs() <= 1e-6 * mag).all()
    assert (t0.abs() > 0).sum() > 1000
    torch.testing.assert_close(x1, x0, rtol=1e-5, atol=1e-5)


def _pair_hash_inputs(encoder, device, n=5000, seed=0):
    """(encode function, cfg, table, x, cotangent) for the packed2 or the
    hash encoder at small widths with O(0.1) table values."""
    from google_nerf_tpu_torch.models import encoders as enc
    from google_nerf_tpu_torch.ops import packed_pair as pp
    g = torch.Generator().manual_seed(seed)
    if encoder == "packed2":
        cfg = pp.packed_pair_config_for_scale(0.5, n_pairs=3,
                                              log2_table_size=12)
        fn, shape = pp.packed_pair_encode, (3, 4096, cfg.row_width)
    else:
        cfg = enc.hashgrid_config_for_scale(0.5, num_levels=6,
                                            log2_hashmap_size=13)
        fn, shape = enc.hash_encode, (6, 8192, 2)
    table = (torch.rand(shape, generator=g) - 0.5) * 0.2
    x = torch.rand((n, 3), generator=g) * 0.98 + 0.01
    gy = torch.randn((n, cfg.out_dim), generator=g)
    return fn, cfg, table.to(device), x.to(device), gy.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["packed2", "hash"])
def test_cuda_pair_and_hash_encoders_match_cpu(encoder):
    """packed2 (P2 on its bf16 table padded to 72 columns, P3) and the hash
    grid (its two kernels, csrc/hash_grid.cu) on the card against their
    CPU runs (the plain versions): forward within 1e-6, dtable within
    1e-5 x its largest entry (f32 atomic sums in another order), dx
    within 1e-5; for packed2 P2 and P3 launched once each, for the hash
    grid its forward and backward kernels once each and P3 never."""
    from google_nerf_tpu_torch.ops.cuda import hash_grid, probe

    def launches():
        return (probe.gather_rows.launches["bfloat16"],
                probe.scatter_add_rows.launches,
                hash_grid.hash_grid_encode.launches,
                hash_grid.hash_grid_grads.launches)
    dev = _card()
    outs = {}
    for d in ("cpu", dev):
        fn, cfg, table, x, gy = _pair_hash_inputs(encoder, d)
        table.requires_grad_(True)
        x.requires_grad_(True)
        before = launches()
        y = fn(table, x, cfg)
        (y * gy).sum().backward()
        after = launches()
        outs[str(d)] = (y.detach().cpu(), table.grad.cpu(), x.grad.cpu())
        if d != "cpu":
            pair = encoder == "packed2"
            assert after == (before[0] + pair, before[1] + pair,
                             before[2] + (not pair), before[3] + (not pair))
    (y0, t0, x0), (y1, t1, x1) = outs["cpu"], outs["cuda"]
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-6)
    assert float((t1 - t0).abs().max()) <= 1e-5 * float(t0.abs().max())
    assert (t0.abs() > 0).sum() > 1000
    torch.testing.assert_close(x1, x0, rtol=1e-5, atol=1e-5)


def _tiny_train(dtype, march="block2"):
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    from google_nerf_tpu_torch.train import system as tsys
    cfg = tsys.TrainConfig(
        model=NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                        packed_levels=4, packed_log2_size=12,
                        compute_dtype=getattr(torch, dtype)),
        batch_size=256, k_samples=256, max_samples=256,
        samples_budget=7 * 256, grid_sample_div=16, random_bg=True,
        exclude_incomplete="backfill", march=march)
    ds = SyntheticDataset(split="train", n_images=4, img_wh=(24, 24),
                          style="textured", device="cpu")
    return tsys, cfg, ds


def _to(v, d):
    if isinstance(v, dict):
        return {k: w.to(d) for k, w in v.items()}
    return v.to(d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_step_matches_cpu(dtype):
    _train_step_card_vs_cpu(dtype, "block2")


@pytest.mark.cuda
def test_cuda_seg_train_step_matches_cpu():
    """As test_cuda_train_step_matches_cpu, at opt.py's march: the seg
    marcher with super-segments (sup 4), f32."""
    _train_step_card_vs_cpu("float32", "seg")


def _train_step_card_vs_cpu(dtype, march):
    """One step from the same state (the port's init after a warmup and a
    sampled grid update on the CPU), batch and draws, on the card and on
    the CPU: loss rtol 1e-4; gradients, as the norm of the
    difference over the CPU's, 1e-4 for the rgb MLP and 1e-3 on the sigma
    path in f32, 2e-2 for all in bf16 (tests/test_torch_train_step.py's
    bounds).  The loss bound is 10x the CPU test's against JAX: the
    per-ray sums are differences of one f32 running sum over the stream
    (JAX's form), which the card scans in f32 and the CPU accumulates in
    double.  The table keeps its init scale: scaled x1e3, as the JAX
    model tests' fixture, the field is noise at the fine levels, and the
    one-ulp differences between the card's and the CPU's ray
    normalisation (torch.linalg.norm reduces in another order) move the
    table gradient past the f32 bound."""
    dev = _card()
    tsys, cfg, ds = _tiny_train(dtype, march)
    st = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    g = torch.Generator().manual_seed(1)
    tsys.grid_update_step(st, cfg, warmup=True, generator=g)
    tsys.grid_update_step(st, cfg, warmup=False, generator=g)
    st["step"] = 300
    scene = ds.scene()
    draws = dict(img_idxs=torch.randint(0, 4, (256,), generator=g),
                 pix_idxs=torch.randint(0, 576, (256,), generator=g),
                 bg=torch.rand((256, 3), generator=g),
                 noise=torch.rand((256,), generator=g))
    out = {}
    for d in ("cpu", dev):
        s = dict(st, params={k: ([w.detach().to(d).requires_grad_()
                                  for w in v] if isinstance(v, list) else
                                 v.detach().to(d).requires_grad_())
                             for k, v in st["params"].items()},
                 occ=st["occ"].to(d), occ_u8=_to(st["occ_u8"], d))
        sc = {k: v.to(d) for k, v in scene.items()}
        dr = {k: v.to(d) for k, v in draws.items()}
        b = tsys.sample_batch(sc, 256, img_idxs=dr["img_idxs"],
                              pix_idxs=dr["pix_idxs"])
        loss, _, grads = tsys.loss_and_grads(s, sc, b, cfg, draws=dr)
        out[str(d)] = (float(loss), {k: v.cpu() for k, v in grads.items()})
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-4 * abs(l0), (l0, l1)
    for k in g0:
        tol = 2e-2 if dtype == "bfloat16" else (
            1e-3 if k.startswith(("packed_table", "sigma_mlp")) else 1e-4)
        rel = float((g1[k] - g0[k]).norm() / g0[k].norm())
        assert rel <= tol, (k, rel)


@pytest.mark.cuda
def test_ssim_and_lpips_on_the_card_match_the_cpu():
    """ssim and LPIPS turn TF32 off for their own convolutions: with the
    cuDNN default left on, the card's scores equal the CPU's to float32
    summation order (ssim rtol 1e-5, LPIPS 1e-4)."""
    from google_nerf_tpu_torch.eval import metrics
    dev = _card()
    assert torch.backends.cudnn.allow_tf32      # the default, left as it is
    g = torch.Generator().manual_seed(0)
    gt = torch.rand((64, 48, 3), generator=g)
    pred = (gt + 0.1 * torch.randn(gt.shape, generator=g)).clamp(0, 1)
    s_cpu = float(metrics.ssim(pred, gt))
    s_card = float(metrics.ssim(pred.to(dev), gt.to(dev)))
    assert abs(s_card - s_cpu) <= 1e-5 * abs(s_cpu), (s_cpu, s_card)
    w, cin, li = {}, 3, 0
    for j, widths in enumerate(metrics._VGG_BLOCKS):
        for cout in widths:
            w[f"conv{li}_w"] = 0.05 * torch.randn((cout, cin, 3, 3),
                                                  generator=g)
            w[f"conv{li}_b"] = 0.05 * torch.randn((cout,), generator=g)
            cin, li = cout, li + 1
        w[f"lin{j}_w"] = 0.05 * torch.randn((1, cin, 1, 1),
                                            generator=g).abs()
    scorer = metrics.LPIPS(device="cpu")
    scorer.weights = w
    l_cpu = float(scorer(pred, gt))
    scorer.weights = {k: v.to(dev) for k, v in w.items()}
    l_card = float(scorer(pred.to(dev), gt.to(dev)))
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu), (l_cpu, l_card)


@pytest.mark.cuda
def test_oneshot_frame_on_the_card_matches_the_cpu():
    """bench.py's one-shot settings (compact main, block2, drain) at toy
    size: the card's frame, its encoder gathering on P2, against the
    CPU's plain gather; rgb/opacity/depth atol 2e-3 (the frame
    tolerance), drain trips and alive rays equal."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import (SyntheticDataset,
                                                      analytic_field)
    from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
    dev = _card()
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                    packed_log2_size=12, packed_levels=4)
    params = init_ngp(torch.Generator().manual_seed(0), cfg, "cpu")
    params["packed_table"] *= 1e3
    c = ((torch.arange(32, dtype=torch.float32) + 0.5) / 32 * 2 - 1) * 0.5
    xyz = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    occ = (analytic_field(xyz.reshape(-1, 3), "textured")[0] > 1.0
           ).reshape(1, 32, 32, 32)
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(32, 32),
                          style="textured", device="cpu")
    o, d = get_rays(torch.as_tensor(ds.directions),
                    torch.as_tensor(ds.poses[0]))
    out = {}
    for dv in ("cpu", dev):
        occ2 = pack_occupancy_block2(occ.to(dv), max_samples=128, scale=0.5)
        p = {k: ([w.to(dv) for w in v] if isinstance(v, list) else v.to(dv))
             for k, v in params.items()}
        out[str(dv)] = render_test_oneshot(
            p, cfg, occ2, o.to(dv), d.to(dv), T_threshold=1e-2,
            max_samples=128, k=32, budget_div=0, straggler_div=2, drain=True,
            march="block2", compact_main=True, chunk=256)
    a, b = out["cpu"], out["cuda"]
    for k in ("rgb", "opacity", "depth"):
        assert float((b[k].cpu() - a[k]).abs().max()) <= 2e-3, k
    assert b["drain_trips"] == a["drain_trips"] > 1
    assert int(b["alive_after_main"]) == int(a["alive_after_main"])


@pytest.mark.cuda
def test_render_test_fast_on_the_card_matches_the_cpu():
    """render_test_fast (validate's renderer) at toy size: the card's
    frame, its encoder gathering on P2, against the CPU's plain gather;
    rgb/opacity/depth atol 2e-3 (the frame tolerance); P2 launched."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import (SyntheticDataset,
                                                      analytic_field)
    from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    from google_nerf_tpu_torch.ops.cuda import probe
    from google_nerf_tpu_torch.ops.grid import pack_occupancy_u8
    from google_nerf_tpu_torch.ops.march_seg import required_dilation_radius
    dev = _card()
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                    packed_log2_size=12, packed_levels=4)
    params = init_ngp(torch.Generator().manual_seed(0), cfg, "cpu")
    params["packed_table"] *= 1e3
    c = ((torch.arange(32, dtype=torch.float32) + 0.5) / 32 * 2 - 1) * 0.5
    xyz = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    occ = (analytic_field(xyz.reshape(-1, 3), "textured")[0] > 1.0
           ).reshape(1, 32, 32, 32)
    words = pack_occupancy_u8(
        occ, required_dilation_radius(8, 32, 256, 0.5),
        super_radius=required_dilation_radius(32, 32, 256, 0.5))
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(32, 32),
                          style="textured", device="cpu")
    o, d = get_rays(torch.as_tensor(ds.directions),
                    torch.as_tensor(ds.poses[0]))
    out = {}
    for dv in ("cpu", dev):
        p = {k: ([w.to(dv) for w in v] if isinstance(v, list) else v.to(dv))
             for k, v in params.items()}
        before = probe.gather_rows.launches["bfloat16"]
        out[str(dv)] = render_test_fast(
            p, cfg, words.to(dv), o.to(dv), d.to(dv), T_threshold=1e-2,
            bucket=256, k=16, n_segs=8, n_keep=4, max_samples=256)
        if dv != "cpu":
            assert probe.gather_rows.launches["bfloat16"] > before
    a, b = out["cpu"], out["cuda"]
    assert float(a["opacity"].mean()) > 0.02        # the frame holds content
    for k in ("rgb", "opacity", "depth"):
        assert float((b[k].cpu() - a[k]).abs().max()) <= 2e-3, k


@pytest.mark.cuda
def test_depth_forward_on_the_card_matches_the_cpu():
    """The LeReS depth network (ResNeXt101-32x8d, encoder-site cIMLE at
    d_latent 32, one minibatch of 5 hypotheses at 128x128) on the card
    against the same weights and latents on the CPU: depth_inference
    norm-relative 1e-4 (f32 with TF32 off on both; cuDNN's convolution
    algorithms sum in other orders), the minibatch's minimum 0.01 on
    both, and TF32 back at its setting after the call."""
    from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                                   depth_inference,
                                                   init_depth_model)
    dev = _card()
    cfg = DepthModelConfig(backbone="resnext101_32x8d", d_latent=32)
    model = init_depth_model(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    rgb = torch.rand((1, 3, 128, 128), generator=gen).expand(5, -1, -1, -1)
    z = torch.randn((5, 32), generator=gen)
    want = depth_inference(model, rgb.contiguous(), z)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = depth_inference(model.to(dev), rgb.contiguous().to(dev),
                              z.to(dev))
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = was
    got = got.cpu()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-4, rel
    assert float(got.min()) == pytest.approx(0.01, abs=1e-6)
    assert not torch.allclose(got[0], got[1])      # the latents differ


@pytest.mark.cuda
def test_depth_train_step_on_the_card_matches_the_cpu():
    """One step of the cIMLE depth trainer (resnet18, encoder-site AdaIN
    at d_latent 8, 64x64, batch 2, the CLI's default loss mode, the same
    loss draws and latents: tools/depth_step_precision's inputs) on the
    card and on the CPU, in float32 and in float64, held to the CPU's
    float64 step over compared_keys (as chip_smoke's card_vs_cpu_step):
    the two float32 losses rtol 1e-4; the card's float64 step within
    1e-9 of the CPU's (the loss, each tensor's gradient and momentum
    trace; seen 2.8e-14); the card's float32 gradients and traces within
    4e-2 of float64 for each tensor and 1e-2 over all (seen 1.9e-2 and
    5.0e-3: float32 loses this much in train-mode BatchNorm's backward
    pass, the CPU 3.6e-3 and 9.7e-4; TF32 in the step gives 6.4e-2 over
    all), with TF32 on outside the step (the backward pass runs inside
    exact_f32 too)."""
    from google_nerf_tpu_torch.tools.depth_step_precision import (
        compare, inputs)
    dev = _card()
    cfg, model, data, z, draws = inputs("resnet18", 64, 2, 8)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        r = compare(cfg, model, data, z, draws, dev)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert r["n_compared"] == len(dict(model.named_parameters())) - 8
    assert r["loss_card_vs_cpu"] <= 1e-4
    f64, f32 = r["card_f64"], r["card"]
    assert max(f64["loss"], f64["grads_tensor_max"],
               f64["traces_tensor_max"]) <= 1e-9, f64
    assert max(f32["grads_tensor_max"], f32["traces_tensor_max"]) <= 4e-2, f32
    assert max(f32["grads"], f32["traces"]) <= 1e-2, f32


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["shift", "focal"])
def test_spvcnn_on_the_card_matches_the_cpu(head):
    """An SPVCNN head at full width (channel ratio 1) on the card against
    the same weights on the CPU, on one voxelized cloud of a 240x320
    depth map (~10k voxels, levels cut to their active sites): the logit
    within rel 1e-4 (f32 products without TF32 on both; index_add_'s
    atomics sum in another order), and the active sites equal."""
    from google_nerf_tpu_torch.depth import spvcnn
    dev = _card()
    yy, xx = np.mgrid[0:240, 0:320]
    depth = (2 + np.sin(xx / 40.0) + 0.3 * np.cos(yy / 30.0)).astype(
        np.float32)
    ch = 3 if head == "shift" else 5
    params = spvcnn.init_spvcnn(torch.Generator().manual_seed(ch), ch,
                                device="cpu")
    cloud = (spvcnn.shift_cloud if head == "shift"
             else spvcnn.focal_cloud)(depth, 280.0, 160.0, 120.0)
    want = spvcnn.spvcnn_apply(params, *cloud)
    got = spvcnn.spvcnn_apply(spvcnn.params_to(params, dev), *cloud)
    assert got.device.type == "cuda"
    got = got.cpu()
    assert float((got - want).abs().max()) <= 1e-4 * max(
        float(want.abs().max()), 0.1)


@pytest.mark.cuda
def test_voxelnet_on_the_card_matches_the_cpu():
    """The dense voxelnet regressor's refiners on the card against the
    CPU, same weights: the shift and focal scale within rel 1e-4 (cuDNN's
    3-D convolutions in f32 with TF32 off, index_add_'s atomics)."""
    from google_nerf_tpu_torch.depth import voxelnet
    dev = _card()
    model = voxelnet.init_voxelnet(torch.Generator().manual_seed(0),
                                   device="cpu")
    rng = np.random.default_rng(0)
    depth = (1.0 + rng.random((120, 160))).astype(np.float32)
    want = (voxelnet.refine_shift(depth, model, 150.0, steps=2),
            voxelnet.refine_focal(depth, model, 150.0, steps=2))
    model.to(dev)
    got = (voxelnet.refine_shift(depth, model, 150.0, steps=2),
           voxelnet.refine_focal(depth, model, 150.0, steps=2))
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * max(abs(w), 0.1), (got, want)
