"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--out result.json]

Phases:
  1. print the card (nvidia-smi name, power limit); build the kernels;
  2. hold K1 (brick_field_tiles_wl) and K2 (brick_field_tiles_tp) against
     their plain PyTorch versions at serving widths (P=16, S=9, Bk=8, bf16
     pool, a few hundred tiles) on seeded inputs;
  3. serve one 800x800 request at full width: packed NGP with random
     weights from --seed, a 256^3 bf16 bake of the textured scene's
     occupancy, the bench.py worklist renderer settings;
  4. render the same frame with both kernels replaced by their plain
     versions and compare;
  5. serve the frame again with the worklist budget cut, so that the
     exact drain (K2) runs;
  6. time the bake, the warm frame and each kernel on the inputs the
     main path gave it (its own device time by torch.profiler, and the
     whole wrapper call by CUDA events), beside its plain version and
     its bound.

Tolerances.  A kernel against its plain version on the same inputs
(phases 2 and 6): tau, rgb and depth atol 1e-4, n_pairs exact; both
compute one function with the same bf16 rounding points, and they have
agreed to within 5e-7.  A kernel against the numpy golden (phase 2, a
subset of tiles; the golden rounds nothing to bf16): the JAX kernel
tests' tau atol/rtol 5e-2, rgb and depth atol 3e-2, n_pairs exact.  The
kernel frame against the plain frame (phase 4) and the drained frame
against the uncut one (phase 5): rgb and opacity max abs difference
1e-4 per pixel, pairs_rendered equal.  Any failed check exits nonzero
before the result line.  The last stdout line is the result JSON; the
line before it lists every kernel with its times and its launches in the
main request of phase 3 (counters reset just before it, read just
after; both kernels must have launched there).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
SERVE_KW = dict(L=96, exact_cull=96, kernel="wl", pbatch=16,
                segment_slots=32, wl_cap=5120, drain_tiles=64, drain_L=128,
                drain_xc=96, max_samples=256, T_threshold=1e-2)
# bench.py:327-330 (its bands=() is implied by the worklist kernel)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_errors(got, want, what="kernel vs plain"):
    """Max abs error over tau, rgb, depth; raises unless it is within
    atol 1e-4 and n_pairs are equal."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: output not finite")
    err = float((g[:, :5] - w[:, :5]).abs().max())
    check(err <= 1e-4, f"{what}: tau/rgb/depth error {err} > 1e-4")
    check(torch.equal(g[:, 5], w[:, 5]), f"{what}: n_pairs differ")
    return err


def golden_errors(got, want, what):
    """The JAX kernel tests' check against the f32/f64 golden: tau
    atol/rtol 5e-2, rgb and depth atol 3e-2, n_pairs exact."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: output not finite")
    tau_ok = (g[:, 0] - w[:, 0]).abs() <= 5e-2 + 5e-2 * w[:, 0].abs()
    check(bool(tau_ok.all()), f"{what}: tau outside atol/rtol 5e-2")
    err_rd = float((g[:, 1:5] - w[:, 1:5]).abs().max())
    check(err_rd <= 3e-2, f"{what}: rgb/depth error {err_rd} > 3e-2")
    check(torch.equal(g[:, 5], w[:, 5]), f"{what}: n_pairs differ")
    return float((g[:, :5] - w[:, :5]).abs().max())


def frame_errors(got, want, what):
    """Per-pixel max abs differences of rgb and opacity (each within
    1e-4) and equal pairs_rendered; returns (rgb MAE, rgb max, opacity
    max)."""
    d_rgb = (got["rgb"] - want["rgb"]).abs()
    d_op = float((got["opacity"] - want["opacity"]).abs().max())
    errs = (float(d_rgb.mean()), float(d_rgb.max()), d_op)
    check(errs[1] <= 1e-4 and d_op <= 1e-4, f"{what}: rgb max {errs[1]}, "
          f"opacity max {d_op} (limit 1e-4)")
    check(int(got["pairs_rendered"]) == int(want["pairs_rendered"]),
          f"{what}: pairs_rendered differ")
    return errs


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps runs after one warm-up, by CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -------------------------------------------------------------- phase 2

def serving_width_inputs(bf, n_tiles, seed, dev):
    """Seeded bricks along +z and tiles of rays marching through them, at
    the serving widths: Bk=8 bf16 slabs, S=9 windows, P=16 groups."""
    g = torch.Generator().manual_seed(seed)
    Bk, V, nb, Lp = 8, 256, 32, 32
    S = bf.window_span(256, Bk, V, 0.5)
    blk = torch.stack([torch.full((nb,), 15), torch.full((nb,), 15),
                       torch.arange(nb)], -1).float()
    lo = (blk * Bk / V * 2 - 1) * 0.5
    hi = ((blk + 1) * Bk / V * 2 - 1) * 0.5
    pool = torch.randn(nb, Bk ** 3, 128, generator=g) * 0.3
    pool[..., 0::16] = torch.randn(nb, Bk ** 3, 8, generator=g) + 2.0
    # each tile lists the column's bricks front to back; nslots cuts it
    order = torch.arange(nb).expand(n_tiles, Lp)
    meta = torch.cat([lo[order], hi[order], torch.zeros(n_tiles, Lp, 2)],
                     -1).reshape(-1, 8)
    o = torch.stack([torch.rand(n_tiles * 64, generator=g) * 0.06 - 0.03,
                     torch.rand(n_tiles * 64, generator=g) * 0.06 - 0.03,
                     torch.full((n_tiles * 64,), -1.0)], -1)
    d = torch.stack([torch.rand(n_tiles * 64, generator=g) * 0.02 - 0.01,
                     torch.rand(n_tiles * 64, generator=g) * 0.02 - 0.01,
                     torch.ones(n_tiles * 64)], -1)
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.full((n_tiles * 64, 1), 0.5),
                      torch.full((n_tiles * 64, 1), 1.5)], -1)
    sh = torch.randn(n_tiles * 64, 16, generator=g) * 0.3
    ws = [(torch.rand(a, b, generator=g) * 2 - 1) * (6 / a) ** 0.5
          for a, b in ((32, 64), (64, 64), (64, 3))]
    nslots = torch.randint(1, Lp + 1, (n_tiles,), generator=g,
                           dtype=torch.int32)
    args = [order.reshape(-1).int(), meta, rays, sh,
            pool.to(torch.bfloat16)] + ws
    args = [a.to(dev).contiguous() for a in args]
    kw = dict(S=S, dt=3 ** 0.5 / 256, tau_max=float(-torch.log(
        torch.tensor(1e-2))), Bk=Bk)
    return args, nslots.to(dev), Lp, kw


def worklist(tiles, nslots, Lp, P, pad):
    """Tile-major (wt, wl, wn, wf) over the given tiles' P-slot groups
    plus `pad` pad steps repeating the last tile."""
    wt, wl, wn, wf = [], [], [], []
    for t in tiles.tolist():
        n = int(nslots[t])
        for g in range(-(-n // P)):
            wt.append(t), wl.append(t * Lp + g * P)
            wn.append(min(P, n - g * P)), wf.append(int(g == 0))
    for _ in range(pad):
        wt.append(wt[-1]), wl.append(wl[-1]), wn.append(0), wf.append(0)
    return [torch.tensor(x, dtype=torch.int32, device=nslots.device)
            for x in (wt, wl, wn, wf)]


def phase2(bf, seed, dev):
    """Each kernel against its plain version on 384 tiles with a carry,
    and against the numpy golden on 16 of them from zero.  The golden
    check opens the live gate (tau_max 1e30): the golden's f32 tau and
    the kernels' bf16-rounded tau differ by up to ~1%, which flips the
    gate for rays that end a brick within that of tau_max and so drops
    or adds a whole brick.  The gate itself is held exactly against the
    plain version above."""
    T = 384
    args, nslots, Lp, kw = serving_width_inputs(bf, T, seed, dev)
    init = torch.zeros(T * 64, 8, device=dev)
    init[::3, 0] = 1.0                 # a carried tau on some rays
    every = torch.arange(T, device=dev)
    wl_args = worklist(every, nslots, Lp, 16, pad=100)
    errs = {}
    got = bf.brick_field_tiles_wl(*args, *wl_args, P=16, init=init, **kw)
    want = bf.brick_field_tiles_wl_plain(*args, *wl_args, P=16, init=init,
                                         **kw)
    errs["brick_field_tiles_wl"] = kernel_errors(got, want)
    tkw = dict(nslots=nslots, Lcall=Lp, P=16, init=init, **kw)
    got = bf.brick_field_tiles_tp(*args, **tkw)
    want = bf.brick_field_tiles_tp_plain(*args, **tkw)
    errs["brick_field_tiles_tp"] = kernel_errors(got, want)
    torch.cuda.synchronize()
    check(float(got[:, 5].sum()) > 0, "phase 2 inputs rendered no pairs")

    sub = every[::T // 16]
    kw = dict(kw, tau_max=1e30)
    rows = (sub[:, None] * 64 + torch.arange(64, device=dev)).reshape(-1)
    gold = torch.as_tensor(bf.brick_field_tiles_reference(
        *[a.float().cpu().numpy() if a.is_floating_point() else
          a.cpu().numpy() for a in args], tid=sub.cpu().numpy(),
        nslots=nslots[sub].cpu().numpy(), inv2s=1.0, V=256, **kw),
        device=dev)[rows]
    got = bf.brick_field_tiles_wl(
        *args, *worklist(sub, nslots, Lp, 16, pad=3), P=16, **kw)[rows]
    errs["brick_field_tiles_wl_vs_golden"] = golden_errors(
        got, gold, "K1 vs numpy golden")
    got = bf.brick_field_tiles_tp(*args, tid=sub, lbase=sub * Lp,
                                  nslots=nslots[sub], Lcall=Lp, P=16,
                                  **kw)[rows]
    errs["brick_field_tiles_tp_vs_golden"] = golden_errors(
        got, gold, "K2 vs numpy golden")
    return errs


# ------------------------------------------------------ phases 3 to 6

def occupancy(cfg, dev):
    """Cascade-0 occupancy: cells whose center has analytic sigma > 1 in
    the textured scene."""
    from google_nerf_tpu_torch.data.synthetic import analytic_field
    G, s = cfg.grid_size, min(0.5, cfg.scale)
    c = (torch.arange(G, device=dev, dtype=torch.float32) + 0.5) / G
    c = (c * 2 - 1) * s
    xyz = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    sigma, _ = analytic_field(xyz.reshape(-1, 3), "textured")
    return (sigma > 1.0).reshape(1, G, G, G)


class Recorder:
    """Wraps a kernel wrapper in the renderer module: records a snapshot
    of every call's inputs (init is cloned: the frame updates in place)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        snap = dict(kw)
        if snap.get("init") is not None:
            snap["init"] = snap["init"].clone()
        snap.pop("out", None)
        self.calls.append((args, snap))
        return self.fn(*args, **kw)


def call_work(bf, args, kw, out, rows, tiles, index_bytes):
    """Bytes and operations one kernel call needs on its inputs.

    rows/tiles: the list rows the call walks, in order, and their tiles;
    index_bytes: the size of its worklist or tile-list arrays.  A ray's
    live-hit pairs are its first n_pairs(out) - n_pairs(init) hit slots
    in list order (liveness only falls), so the samples the field must
    evaluate and the slabs it must read follow from geometry and the
    output's pair count."""
    pool_blk, meta, rays, _, pool3 = args[:5]
    n0, n1, hit = bf.slab_window(rays.view(-1, 64, 8)[tiles], meta[rows],
                                 kw["dt"])                     # (E, 64)
    S = kw["S"]
    init = kw.get("init")
    added = out[:, 5] - (init[:, 5] if init is not None else 0.0)
    added = added.view(-1, 64)[tiles]                          # (E, 64)
    # running hit count within each tile's run of consecutive entries
    cum = torch.cumsum(hit.int(), 0)
    first = torch.ones_like(tiles, dtype=torch.bool)
    first[1:] = tiles[1:] != tiles[:-1]
    start = torch.cummax(torch.where(first, torch.arange(
        len(tiles), device=tiles.device), 0), 0).values
    base = (cum - hit.int())[start]
    live_hit = hit & ((cum - base) <= added)
    samples = int((torch.clamp(n1 - n0 + 1, max=S) * live_hit).sum())
    slots = live_hit.any(1)
    blocks = torch.unique(pool_blk[rows][slots]).numel()
    n_tiles = torch.unique(tiles).numel()
    nbytes = (blocks * pool3.shape[1] * 128 * 2          # slabs, once each
              + len(rows) * (8 * 4 + 4)                  # meta + block id
              + n_tiles * 64 * (8 + 16 + 8 + 8) * 4      # rays sh init out
              + (32 * 64 + 64 * 64 + 64 * 3) * 4         # MLP weights
              + index_bytes)
    # per live sample: trilerp 8x16 MACs, MLP 16x64 (h half of layer 1)
    # + 64x64 + 64x3 MACs, composite ~10; per ray: the 16x64 sh half
    flops = (samples * (2 * (8 * 16 + 16 * 64 + 64 * 64 + 64 * 3) + 10)
             + n_tiles * 64 * 2 * 16 * 64)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return dict(bytes=nbytes, flops=flops, samples=samples,
                live_slots=int(slots.sum()), distinct_slabs=blocks,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def wl_rows(args, kw):
    """K1 call: (rows, tiles, index bytes) of its worklist."""
    wt, wl, wn = (a.long() for a in args[8:11])
    P = kw["P"]
    k = torch.arange(P, device=wt.device)
    valid = k[None] < wn[:, None].clamp(max=P)
    rows = (wl[:, None] + k[None])[valid]
    tiles = wt[:, None].expand_as(valid)[valid]
    return rows, tiles, 4 * 4 * wt.numel()


def tp_rows(args, kw):
    """K2 call: (rows, tiles, index bytes) of its tile lists."""
    tid, lb, ns = (kw[k].long() for k in ("tid", "lbase", "nslots"))
    k = torch.arange(kw["Lcall"], device=tid.device)
    valid = k[None] < ns[:, None]
    return ((lb[:, None] + k[None])[valid],
            tid[:, None].expand_as(valid)[valid], 3 * 4 * tid.numel())


def time_calls(fn, calls, reps):
    """Mean ms per call over the recorded calls, by CUDA events around
    the whole call (output buffers reused: each run copies init into
    them, as the frame's in-place call does)."""
    outs = [torch.empty_like(a[2][:, :8]) for a, _ in calls]
    total = 0.0
    for (a, k), o in zip(calls, outs):
        total += cuda_ms(lambda: fn(*a, **k, out=o), reps)
    return total / len(calls)


def kernel_device_ms(fn, calls, reps, kernel):
    """The kernel's own device time per launch, by torch.profiler, over
    reps runs of each recorded call: the wrapper's checks, the copy of
    init into the output and the launch gaps are not in it.  None if
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    outs = [torch.empty_like(a[2][:, :8]) for a, _ in calls]
    for (a, k), o in zip(calls, outs):
        fn(*a, **k, out=o)                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for (a, k), o in zip(calls, outs):
            for _ in range(reps):
                fn(*a, **k, out=o)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and kernel in e.key and e.self_device_time_total > 0]
    n = sum(e.count for e in ev)
    if n != reps * len(calls):
        return None
    return sum(e.self_device_time_total for e in ev) / 1e3 / n


def profile_frame(serve):
    """Device time of one frame by torch.profiler: busy ms, its share of
    the profiled wall time, device-kernel count and the top device ops.
    The profiler's own overhead inflates the wall time it is set against."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.time()
        serve()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    # device-side entries only: a CPU op's entry repeats its kernels' time
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    if busy_ms == 0:
        return dict(device_busy_ms="not measured", wall_ms=wall_ms)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms,
                device_ops=sum(e.count for e in ev),
                top_ms={e.key[:60]: e.self_device_time_total / 1e3
                        for e in top})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results "
                    "as JSON to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    import google_nerf_tpu_torch.models.render_brick_mxu as rbm
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.ops.cuda import brick_field as bf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1: card and build
    card = card_line()
    print(card, flush=True)            # name, power limit as nvidia-smi says

    t0 = time.time()
    lib = bf.build()
    log = lib.with_suffix(".log").read_text()
    print(f"phase 1: built {lib.name} in {time.time() - t0:.1f} s; "
          + "; ".join(l.split("info    : ")[-1] for l in log.splitlines()
                      if "registers" in l or "spill" in l), flush=True)

    # ---- 2: kernels against plain versions at serving widths
    errs2 = phase2(bf, args.seed, dev)
    print(f"phase 2: kernels vs plain at serving widths, max abs err "
          f"{errs2}", flush=True)

    # ---- 3: the main path at full width
    cfg = NGPConfig(scale=0.5, encoder="packed", grid_size=128,
                    compute_dtype=torch.bfloat16)
    params = init_ngp(torch.Generator().manual_seed(args.seed), cfg, dev)
    params["packed_table"] *= 1e3
    occ = occupancy(cfg, dev)
    bcfg = BakedConfig(voxel_res=256, block=8, dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.time()
    baked = bake(params, cfg, occ, bcfg, device=dev)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    geo = brick_geometry(baked["block_map"], bcfg, cfg)
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(800, 800),
                          style="textured", device=dev)
    o, d = get_rays(torch.as_tensor(ds.directions, device=dev),
                    torch.as_tensor(ds.poses[0], device=dev))
    print(f"phase 3: occupancy {int(occ.sum())} cells, baked "
          f"{baked['n_blocks']} bricks in {bake_s:.2f} s", flush=True)

    def serve(**over):
        return rbm.render_brick_mxu(baked, cfg, o, d, 800, 800, bcfg=bcfg,
                                    geometry=geo, device=dev,
                                    **dict(SERVE_KW, **over))

    rec_wl = Recorder(rbm.brick_field_tiles_wl)
    rec_tp = Recorder(rbm.brick_field_tiles_tp)
    rbm.brick_field_tiles_wl, rbm.brick_field_tiles_tp = rec_wl, rec_tp
    bf.brick_field_tiles_wl.launches = bf.brick_field_tiles_tp.launches = 0
    frame = serve()
    torch.cuda.synchronize()
    launches_a = (bf.brick_field_tiles_wl.launches,
                  bf.brick_field_tiles_tp.launches)
    rgb = frame["rgb"]
    check(tuple(rgb.shape) == (800 * 800, 3), f"rgb shape {rgb.shape}")
    check(bool(torch.isfinite(rgb).all()), "rgb not finite")
    check(bool(((rgb >= 0) & (rgb <= 1 + 1e-5)).all()), "rgb outside [0,1]")
    check(int(frame["pairs_undrained"]) == 0, "main frame left pairs "
          "undrained")
    check(int(frame["pairs_rendered"]) > 0, "main frame rendered no pairs")
    check(launches_a[0] > 0, "K1 not launched on the main path")
    check(launches_a[1] > 0, "K2 (drain) not launched on the main path")
    print(f"phase 3: frame pairs_rendered {int(frame['pairs_rendered'])} "
          f"pairs_undrained {int(frame['pairs_undrained'])} trunc_tiles "
          f"{int(frame['trunc_tiles'])} dma_slots {int(frame['dma_slots'])}"
          f"; launches K1 {launches_a[0]} K2 {launches_a[1]}; mean opacity "
          f"{float(frame['opacity'].mean()):.4f}", flush=True)

    # ---- 4: the same frame through the plain versions
    rbm.brick_field_tiles_wl = bf.brick_field_tiles_wl_plain
    rbm.brick_field_tiles_tp = bf.brick_field_tiles_tp_plain
    plain = serve()
    rbm.brick_field_tiles_wl, rbm.brick_field_tiles_tp = rec_wl, rec_tp
    print(f"phase 4: pairs_rendered kernel {int(frame['pairs_rendered'])}"
          f" plain {int(plain['pairs_rendered'])}", flush=True)
    mae, dmax, dop = frame_errors(frame, plain, "kernel frame vs plain")
    print(f"phase 4: plain frame rgb MAE {mae:.3e}, rgb max diff "
          f"{dmax:.3e}, opacity max diff {dop:.3e}", flush=True)
    check(int(plain["pairs_undrained"]) == 0, "plain frame left pairs "
          "undrained")

    # ---- 5: a budget cut below the segment load, so the drain runs
    real_groups = int((rec_wl.calls[0][0][10] > 0).sum())
    cut = max(real_groups - 40, 1)
    bf.brick_field_tiles_wl.launches = bf.brick_field_tiles_tp.launches = 0
    drained = serve(wl_cap=cut)
    torch.cuda.synchronize()
    launches_b = (bf.brick_field_tiles_wl.launches,
                  bf.brick_field_tiles_tp.launches)
    check(launches_b[1] > 0, "K2 (drain) not launched with the budget cut")
    dmae = float((drained["rgb"] - rgb).abs().mean())
    print(f"phase 5: wl_cap {cut} (segment-0 load {real_groups} groups): "
          f"pairs_undrained {int(drained['pairs_undrained'])} trunc_tiles "
          f"{int(drained['trunc_tiles'])}; launches K1 {launches_b[0]} K2 "
          f"{launches_b[1]}; rgb MAE vs uncut {dmae:.3e}", flush=True)
    if int(drained["pairs_undrained"]) == 0:
        frame_errors(drained, frame, "drained frame vs uncut")
    rbm.brick_field_tiles_wl = rec_wl.fn
    rbm.brick_field_tiles_tp = rec_tp.fn

    # ---- 6: timings; each kernel on every call the two requests made
    frame_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        serve()
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.time() - t0))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = profile_frame(serve)
    print(f"phase 6: profiled frame: {breakdown}", flush=True)
    kernels = []
    for i, (name, kname, fn, plain_fn, calls, rows_of, src) in enumerate((
            ("brick_field_tiles_wl", "brick_field_wl_kernel",
             bf.brick_field_tiles_wl, bf.brick_field_tiles_wl_plain,
             rec_wl.calls, wl_rows,
             "google_nerf_tpu/ops/pallas/brick_field.py:936"),
            ("brick_field_tiles_tp", "brick_field_tp_kernel",
             bf.brick_field_tiles_tp, bf.brick_field_tiles_tp_plain,
             rec_tp.calls, tp_rows,
             "google_nerf_tpu/ops/pallas/brick_field.py:692"))):
        errs, works = [], []
        for a, k in calls:
            got = fn(*a, **k)
            errs.append(kernel_errors(got, plain_fn(*a, **k)))
            works.append(call_work(bf, a, k, got, *rows_of(a, k)))
        ms = kernel_device_ms(fn, calls, 20, kname)
        call_ms = time_calls(fn, calls, reps=20)
        ms_by = "profiler device time per launch"
        if ms is None:                  # no device trace: the whole call
            ms, ms_by = call_ms, "CUDA events around the wrapper call"
        plain_ms = time_calls(plain_fn, calls, reps=2)
        bound = sum(w["bound_ms"] for w in works) / len(works)
        kernels.append(dict(
            name=name, route="cuda",
            source="google_nerf_tpu_torch/csrc/brick_field.cu",
            replaces=src,
            launches=launches_a[i],
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=max(works, key=lambda w: w["bound_ms"])["bound_by"],
            library_ms=None, ms_by=ms_by, wrapper_ms=call_ms,
            calls_timed=len(calls),
            launches_budget_cut_frame=launches_b[i],
            samples_per_call=sum(w["samples"] for w in works) / len(works),
            live_slots_per_call=sum(w["live_slots"] for w in works)
            / len(works),
            distinct_slabs_per_call=sum(w["distinct_slabs"] for w in works)
            / len(works)))
        print(f"phase 6: {name}: kernel {ms:.4f} ms ({ms_by}), whole "
              f"wrapper call {call_ms:.4f} ms by CUDA events (plain "
              f"{plain_ms:.1f}, bound {bound:.5f} by "
              f"{kernels[-1]['bound_by']}) over "
              f"{len(calls)} calls of the two requests; max abs err "
              f"{max(errs):.2e}",
              flush=True)
    print(f"phase 6: card {card}; bake {bake_s:.3f} s; warm frame median "
          f"{statistics.median(frame_ms):.2f} ms of {frame_ms}; peak "
          f"memory {peak_gib:.2f} GiB; per frame K1 {launches_a[0]} calls, "
          f"K2 {launches_a[1]} calls; total {time.time() - t_start:.0f} s",
          flush=True)

    result = dict(card=card, seed=args.seed, bake_s=bake_s,
                  frame_ms=frame_ms, peak_gib=peak_gib, phase2_err=errs2,
                  profile=breakdown,
                  plain_frame_rgb_mae=mae, plain_frame_rgb_max=dmax,
                  plain_frame_opacity_max=dop,
                  pairs_rendered=int(frame["pairs_rendered"]),
                  dma_slots=int(frame["dma_slots"]), kernels=kernels)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
