"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed N] [--out result.json]

Phases:
  1. print the card (nvidia-smi name, power limit); build the kernels;
  2. hold K1 (brick_field_tiles_wl), K2 (brick_field_tiles_tp), K3
     (brick_field_tiles), K4 (brick_field_tiles_t) and K5
     (brick_field_tiles_rgba) against their plain PyTorch versions at
     serving widths (Bk=8, bf16 pool, a few hundred tiles of 32-slot
     lists) on seeded inputs, and against the port's numpy goldens on 16
     of those tiles.  The carry kernels (K1, K2, K5) start from an init
     with tau partly spent on some rays and at or past tau_max on others
     (on every ray of some tiles), and some tiles list no slot: the rows
     of those tiles must keep init bit for bit (K1, K2 and K5 return
     early there);
  3. the worklist request `wl256`: one 800x800 frame at full width,
     packed NGP with random weights from --seed, a 256^3 bf16 bake of the
     textured scene's occupancy, the bench.py worklist settings (K1 and
     the K2 drain);
  4. the same frame with both kernels replaced by their plain versions;
  5. the wl256 frame again with the worklist budget cut, so that the
     exact drain (K2) runs on purpose;
  6. time the bake, the warm frame and K1 on the inputs the request gave
     it (its own device time by torch.profiler, and the whole wrapper
     call by CUDA events), beside its plain version and its bound;
  7. a 512^3 bf16 bake of the same model and the per-chunk requests at
     800x800: `tp512` (K2, bench.py's mxu stage), `t512` (K4) and `n512`
     (K3) (test.py's defaults with occupancy bands), and `rgba512` (K5
     after the per-frame RGBA bake, tools/fps_mxu2.py's rgba settings).
     Each request: its counters; every kernel call it made against the
     plain version on the same inputs; the whole frame against the frame
     rendered through the plain version; its warm frame time; its
     kernel's device time, wrapper time, plain time and bound.  n512 is
     also held against t512.  K1-K5 (csrc/brick_field_dense.cu) also
     report their live samples and slots per call, the bound by bytes and
     by operations apart, and the pool bytes their design requests per
     call by a model (dense_pool_model; not a measurement).
  8. the tool path, P1-P5: `kernel_probe` (P1 and P2, the row gather on
     f32 and bf16 tables; P3, the atomic scatter-add; P4, the bulk-copy
     row gather; at tools/pallas_probe.py's sizes on seeded inputs) and
     `kernel_ladder` (P5, the 17 rungs of tools/mosaic_bisect.py on its
     operands), each run through its entry point with the P counters at
     0; then each kernel against its plain version, its device time
     (torch.profiler; for P3 the whole call, its fill and its adds, as
     the bound counts), wrapper time (CUDA events), plain time, the time
     of each one-call PyTorch version of the same function
     (`index_select` and `tab[idx]`, `index_add_`; P1-P4; the faster is
     `library_ms`) and its bound; P5 also each rung's device time and
     bound;
  9. training: bench.py's recipe at full width (the packed NGP of phase 3,
     bf16, batch 8192, budget 57344, max_samples 512, block2 march,
     random backgrounds, backfill; the grid update every 16 steps, warmup
     for 256) on the textured scene (40 images at 256^2), 1024 fused steps
     from --seed with the P2 and P3 counters at 0 just before (read just
     after; the encoder's forward gather is P2, its table gradient P3).
     The loss must be finite at every 64th step and the last, the train
     psnr at the last step >= 45 dB (bench.py's anchor 48.77, a TPU-run
     quality figure), the occupancy fraction in (0.001, 0.5); step 450
     runs under torch.cuda.set_sync_debug_mode("error") (no host sync);
     step 400 is profiled (busy ms, share, device ops, top ops).  Then
     one step from the trained state, batch and draws, with P2/P3 and
     with their plain versions.  Reported: ms per step over steps
     512-1023 (grid cadence included, as bench.py times them), rays/s,
     psnr at 512 and 1024, s_per_ray, mask_frac, peak memory; P2 and P3
     on the inputs the encoder gave them (458,752 rows) measured as in
     phase 8, their entries on the kernels line with request "train";
 10. serving the trained state: its params and occupancy baked at 256^3
     and the wl256 request on phase 3's pose, K1 and the K2 drain; the
     frame against the plain frame; PSNR against the pose's ground truth
     >= 40 dB (bench.py's anchor 42.63, a TPU-run quality figure); the
     warm frame ms.

Tolerances.  A kernel against its plain version on the same inputs
(phases 2, 6 and 7): tau, rgb and depth atol 1e-4, n_pairs exact; both
compute one function with the same bf16 rounding points (K1-K4 sum
their MLP products inside mma.sync, in another order than a plain f32
product, which could round a hidden activation to the neighbouring bf16
value; on these inputs it moves rgb by less than 1e-5).  A kernel
against the numpy golden (phase 2, 16 tiles, live gate open; the golden
rounds nothing to bf16): the JAX kernel tests' tau atol/rtol 5e-2, rgb
and depth atol 3e-2, n_pairs exact.  A kernel frame against its plain
frame (phases 4 and 7) and the drained frame against the uncut one
(phase 5): rgb and opacity max abs difference 1e-4 per pixel and the
counters equal.  n512 against t512: rgb max abs 2e-3 (the JAX test's for
those two kernels, whose corner weights differ in the last bit) and
pairs_rendered equal.  Phase 8: P1, P2 and P4 bitwise, P3 within atol
1e-5 (atomic f32 sums in a varying order), the rungs exactly or within
rtol 1e-5 (k13, k15, k16: f32 sums in another order, exp and sigmoid).
Phase 9's kernel step against the plain step: the loss within rtol 1e-6
and every gradient but the table's within rtol 1e-6 (the forward gather
copies bytes, so both runs compute the same values); the table gradient
within 1e-6 x the sum of |payload| of each (row, column), the P3 card
test's bound for atomic f32 sums.  Phase 10's frame against its plain
frame: opacity 1e-4 per pixel and the counters equal; rgb 1e-4 per
pixel on all but 0.01% of the pixels, which may differ by up to 2e-3
(a bf16 hidden activation rounded the other way after mma.sync's sum,
see trained_frame_errors).
Any failed check exits nonzero before the result
line.  The last stdout line is the result JSON; the line before it lists
every kernel with its times and its launches in its request (counters
reset just before the request, read just after; each kernel must have
launched there).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from google_nerf_tpu_torch.tools.brick_inputs import serving_width_inputs
from google_nerf_tpu_torch.tools.kernel_probe import cuda_ms

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
H100_F32_FLOPS = 67e12          # fp32 outside the tensor cores
PALLAS = "google_nerf_tpu/ops/pallas/brick_field.py"
CSRC = "google_nerf_tpu_torch/csrc"
SERVE_KW = dict(L=96, exact_cull=96, kernel="wl", pbatch=16,
                segment_slots=32, wl_cap=5120, drain_tiles=64, drain_L=128,
                drain_xc=96, max_samples=256, T_threshold=1e-2)
# bench.py:327-330 (its bands=() is implied by the worklist kernel)
TP512 = dict(L=192, exact_cull=48, kernel="tp", pbatch=8, bands=(),
             segment_slots=8, drain_tiles=256, drain_L=384, drain_xc=384,
             max_samples=256, T_threshold=1e-2)
# bench.py:284-288, the 512^3 mxu stage
T512 = dict(L=192, exact_cull=48, kernel="t", pbatch=8, bands="auto",
            segment_slots=0, drain_tiles=256, drain_L=256, drain_xc=96,
            macro_tiles=8, macro_L=1024, max_samples=512, T_threshold=1e-2)
# test.py:166-182 with opt.py's defaults (opt.py:147-199, 232) and
# --brick_mxu_kernel t --brick_mxu_seg 0, which turns the bands on
RGBA512 = {k: v for k, v in TP512.items() if k not in ("kernel", "pbatch")}
# tools/fps_mxu2.py:52 (rgba, 256-sample lattice, segments of 8) on the
# tp512 lists
KERNELS = ("brick_field_tiles_wl", "brick_field_tiles_tp",
           "brick_field_tiles", "brick_field_tiles_t",
           "brick_field_tiles_rgba")
# pool lane rows of the lane-major layouts: K4's transposed pool and
# K5's pre-shaded slabs (K1-K3 read the row pool)
LANE_ROWS = {"brick_field_tiles_t": 128, "brick_field_tiles_rgba": 32}
OFF_LINE = ("rungs", "modelled_pool_bytes_per_call")   # --out's JSON only


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


COUNTERS = ("pairs_rendered", "pairs_undrained", "trunc_tiles", "dma_slots")


def frame_errors(got, want, what, limit=1e-4, counters=COUNTERS):
    """Per-pixel max abs differences of rgb and opacity (each within
    `limit`) and equal counters; returns (rgb MAE, rgb max, opacity
    max)."""
    d_rgb = (got["rgb"] - want["rgb"]).abs()
    d_op = float((got["opacity"] - want["opacity"]).abs().max())
    errs = (float(d_rgb.mean()), float(d_rgb.max()), d_op)
    check(errs[1] <= limit and d_op <= limit, f"{what}: rgb max {errs[1]}, "
          f"opacity max {d_op} (limit {limit})")
    for k in counters:
        check(int(got[k]) == int(want[k]), f"{what}: {k} {int(got[k])} vs "
              f"{int(want[k])}")
    return errs


def counters_of(frame):
    return {k: int(frame[k]) for k in COUNTERS}


def frame_ms(serve, n):
    """Host-clock ms of n warm frames, each ended by a synchronize."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        serve()
        torch.cuda.synchronize()
        times.append(1e3 * (time.time() - t0))
    return times


# -------------------------------------------------------------- phase 2

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


def numpy_args(args):
    return [a.float().cpu().numpy() if a.is_floating_point() else
            a.cpu().numpy() for a in args]


def phase2(bf, seed, dev):
    """Each kernel against its plain version on 384 tiles (K1, K2, K5
    with a carry), and against the numpy golden on 16 of them from zero.
    The golden check opens the live gate (tau_max 1e30): the golden's f32
    tau and the kernels' bf16-rounded tau differ by up to ~1%, which
    flips the gate for rays that end a brick within that of tau_max and
    so drops or adds a whole brick.  The gate itself is held exactly
    against the plain versions."""
    T = 384
    args, rgba, nslots, Lp, kw = serving_width_inputs(T, seed, dev)
    argsT = list(args)
    argsT[4] = args[4].transpose(1, 2).contiguous()
    init = torch.zeros(T * 64, 8, device=dev)
    init[::3, 0] = 1.0                 # a carried tau on some rays
    init[1::5, 0] = kw["tau_max"] + 1.0           # some rays saturated
    init.view(T, 64, 8)[5::11, :, 0] = kw["tau_max"]   # whole tiles
    ns0 = nslots.clone()
    ns0[3::7] = 0                      # some tiles list no slot
    every = torch.arange(T, device=dev)
    wl_args = worklist(every, ns0, Lp, 16, pad=100)
    tkw = dict(nslots=nslots, Lcall=Lp, **kw)
    ckw = dict(tkw, nslots=ns0, init=init)
    runs = {
        "brick_field_tiles_wl": (args + wl_args, dict(P=16, init=init, **kw)),
        "brick_field_tiles_tp": (args, dict(P=16, **ckw)),
        "brick_field_tiles": (args, tkw),
        "brick_field_tiles_t": (argsT, tkw),
        "brick_field_tiles_rgba": (args[:3] + [rgba], ckw)}
    # the rows of tiles with no slot or no live ray, which must keep init
    keep = ((ns0 == 0)[:, None] | (init[:, 0] >= kw["tau_max"]).view(T, 64)
            .all(1, keepdim=True)).expand(T, 64).reshape(-1)
    errs = {}
    for name, (a, k) in runs.items():
        got = getattr(bf, name)(*a, **k)
        errs[name] = kernel_errors(got, getattr(bf, name + "_plain")(*a, **k),
                                   f"{name} vs plain (phase 2)")
        check(float(got[:, 5].sum()) > 0, f"phase 2 {name} rendered no pairs")
        if "init" in k:
            check(torch.equal(got[keep], init[keep]),
                  f"phase 2 {name}: a tile with no slot or no live ray "
                  "changed")

    sub = every[::T // 16]
    kw = dict(kw, tau_max=1e30)
    rows = (sub[:, None] * 64 + torch.arange(64, device=dev)).reshape(-1)
    gkw = dict(tid=sub.cpu().numpy(), nslots=nslots[sub].cpu().numpy(),
               inv2s=1.0, V=256, **kw)
    gold = torch.as_tensor(bf.brick_field_tiles_reference(
        *numpy_args(args), **gkw), device=dev)[rows]
    gold_rgba = torch.as_tensor(bf.brick_field_rgba_reference(
        *numpy_args(args[:3] + [rgba]), **gkw), device=dev)[rows]
    lkw = dict(tid=sub, lbase=sub * Lp, nslots=nslots[sub], Lcall=Lp, **kw)
    gots = {
        "brick_field_tiles_wl": bf.brick_field_tiles_wl(
            *args, *worklist(sub, nslots, Lp, 16, pad=3), P=16, **kw),
        "brick_field_tiles_tp": bf.brick_field_tiles_tp(*args, P=16, **lkw),
        "brick_field_tiles": bf.brick_field_tiles(*args, **lkw),
        "brick_field_tiles_t": bf.brick_field_tiles_t(*argsT, **lkw),
        "brick_field_tiles_rgba": bf.brick_field_tiles_rgba(
            *args[:3], rgba, **lkw)}
    for name, got in gots.items():
        want = gold_rgba if name == "brick_field_tiles_rgba" else gold
        errs[name + "_vs_golden"] = golden_errors(
            got[rows], want, f"{name} vs numpy golden")
    return errs


# ------------------------------------------------------ the requests

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


def run_request(rbm, bf, name, serve):
    """Serve one request with `name`'s calls recorded and every kernel's
    launch counter set to 0 just before; returns (frame, calls, launches
    of each kernel in this request)."""
    rec = Recorder(getattr(rbm, name))
    setattr(rbm, name, rec)
    for k in KERNELS:
        getattr(bf, k).launches = 0
    try:
        frame = serve()
        torch.cuda.synchronize()
    finally:
        setattr(rbm, name, rec.fn)
    return frame, rec.calls, {k: getattr(bf, k).launches for k in KERNELS}


def plain_frame(rbm, bf, names, serve):
    """The request rendered with `names` replaced by their plain versions."""
    saved = {n: getattr(rbm, n) for n in names}
    for n in names:
        setattr(rbm, n, getattr(bf, n + "_plain"))
    try:
        return serve()
    finally:
        for n, f in saved.items():
            setattr(rbm, n, f)


def check_frame(frame, what, n_pixels):
    rgb = frame["rgb"]
    check(tuple(rgb.shape) == (n_pixels, 3), f"{what}: rgb shape {rgb.shape}")
    check(bool(torch.isfinite(rgb).all()), f"{what}: rgb not finite")
    check(bool(((rgb >= 0) & (rgb <= 1 + 1e-5)).all()),
          f"{what}: rgb outside [0, 1]")
    check(int(frame["pairs_rendered"]) > 0, f"{what}: no pairs rendered")


def call_work(bf, args, kw, out, rows, tiles, index_bytes, rgba=False,
              lane_rows=0):
    """Bytes and operations one kernel call needs on its inputs.

    rows/tiles: the list rows the call walks, in order, and their tiles;
    index_bytes: the size of its worklist or tile-list arrays.  A ray's
    live-hit pairs are its first n_pairs(out) - n_pairs(init) hit slots
    in list order (liveness only falls), so the samples the field must
    evaluate follow from geometry and the output's pair count.  Of the
    pool the function needs each distinct voxel those samples touch, in
    any brick, once: its 8 corners x 16 features (256 bytes; K5 8 x 4, 64
    bytes).  rgba: K5 (no sh, no MLP, 32-lane slabs).  lane_rows: the
    lane rows of the pool's lane-major layout (K4 128, K5 32; K1-K3's row
    pool 0), for the model of the pool reads the design requests
    (dense_pool_model).  That model starts a batch of 8 list slots at
    every 8th of a tile's rows in the call (pos // 8 below).  K2-K5 batch
    a tile's list from lbase, so it holds for them; K1 batches each
    worklist step apart, so it holds while every step but a tile's last
    lists P rows with P a multiple of 8, as the worklist frame's steps
    and phase 2's do."""
    pool_blk, meta, rays = args[:3]
    pool3 = args[3] if rgba else args[4]
    vox = kw["Bk"] ** 3
    n0, n1, hit = bf.slab_window(rays.view(-1, 64, 8)[tiles], meta[rows],
                                 kw["dt"])                     # (E, 64)
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
    ei, lid = sample_voxels(rays, meta, rows, tiles, live_hit, n0, n1, kw)
    samples = ei.numel()
    voxels = torch.unique(pool_blk[rows][ei].long() * vox + lid).numel()
    slots = live_hit.any(1)
    n_tiles = torch.unique(tiles).numel()
    ray_floats = 8 + 8 + (8 if init is not None else 0) + (0 if rgba else 16)
    nbytes = (voxels * pool3[0].numel() * 2 // vox      # voxels, once each
              + len(rows) * (8 * 4 + 4)                   # meta + block id
              + n_tiles * 64 * ray_floats * 4             # rays sh init out
              + index_bytes)
    if rgba:
        # per live sample: trilerp 8x4 MACs, composite ~10
        flops = samples * (2 * 8 * 4 + 10)
    else:
        nbytes += (32 * 64 + 64 * 64 + 64 * 3) * 4       # MLP weights
        # per live sample: trilerp 8x16 MACs, MLP 16x64 (h half of layer
        # 1) + 64x64 + 64x3 MACs, composite ~10; per ray: the 16x64 sh half
        flops = (samples * (2 * (8 * 16 + 16 * 64 + 64 * 64 + 64 * 3) + 10)
                 + n_tiles * 64 * 2 * 16 * 64)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    work = dict(bytes=nbytes, flops=flops, samples=samples,
                live_slots=int(slots.sum()), distinct_voxels=voxels,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_bytes_ms=1e3 * t_bytes, bound_ops_ms=1e3 * t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    # rays alive at the start of their batch of 8 list slots: those whose
    # hits before it are fewer than their live hits, or whose tau never
    # reached tau_max
    pos = torch.arange(len(tiles), device=tiles.device) - start
    bstart = start + pos // 8 * 8
    spent = ((cum - hit.int())[bstart] - base) >= added
    ended = out.view(-1, 64, 8)[tiles][..., 0] >= kw["tau_max"]
    sigma_pairs = hit & ~(spent & ended)
    work["modelled_pool_bytes"] = dense_pool_model(
        sample_voxels(rays, meta, rows, tiles, sigma_pairs, n0, n1, kw),
        (ei, lid), vox, lane_rows)
    return work


def sample_voxels(rays, meta, rows, tiles, pairs, n0, n1, kw):
    """Entry index and brick-local voxel of every window sample of the
    (entry, ray) pairs marked in `pairs` (E, 64), located as the kernels
    locate them."""
    S, Bk = kw["S"], kw["Bk"]
    dt_t = torch.tensor(kw["dt"], device=rays.device)
    r = rays.view(-1, 64, 8)[tiles]                            # (E, 64, 8)
    n_s = n0[..., None] + torch.arange(S, device=rays.device)
    ok = pairs[..., None] & (n_s <= n1[..., None])
    ei, ri, si = ok.nonzero(as_tuple=True)
    ts = r[ei, ri, 6] + (n_s[ei, ri, si] + 0.5) * dt_t
    xyz = r[ei, ri, 0:3] + ts[:, None] * r[ei, ri, 3:6]
    lo, hi = meta[rows][ei, 0:3], meta[rows][ei, 3:6]
    u = torch.clamp((xyz - lo) * (torch.full_like(lo, float(Bk)) / (hi - lo)),
                    0.0, Bk - 1e-3)
    v0 = torch.floor(u)
    return ei, ((v0[:, 0] * Bk + v0[:, 1]) * Bk + v0[:, 2]).long()


def dense_pool_model(sigma, shade, vox, lane_rows):
    """Pool bytes the K1-K5 design requests in one call, by a model, not
    a measurement: each 32-byte sector counted once per (tile, slot) that
    reads it.  sigma: (entry, voxel) of the sigma pass's samples, every
    window sample of a hit pair whose ray is alive at its batch's start,
    which reads feature 0 of the 8 corners; shade: those of the live
    pairs' samples, which read the whole voxel.  K1-K3's 256-byte voxel row
    holds corner c's features in sector c, so both passes touch all 8
    sectors of a row (and shade's samples are among sigma's); K4 and K5
    read a voxel's value from each lane row of the lane-major slab
    (lane_rows: K4 128, K5 32), 16 voxels a sector: 8 lane rows in the
    sigma pass, the others in shading."""
    (es, ls), (eh, lh) = sigma, shade
    if not lane_rows:
        return torch.unique(es * vox + ls).numel() * 256
    return (torch.unique(es * vox + ls // 16).numel() * 8 * 32
            + torch.unique(eh * vox + lh // 16).numel()
            * (lane_rows - 8) * 32)


def wl_rows(args, kw):
    """K1 call: (rows, tiles, index bytes) of its worklist."""
    wt, wl, wn = (a.long() for a in args[8:11])
    P = kw["P"]
    k = torch.arange(P, device=wt.device)
    valid = k[None] < wn[:, None].clamp(max=P)
    rows = (wl[:, None] + k[None])[valid]
    tiles = wt[:, None].expand_as(valid)[valid]
    return rows, tiles, 4 * 4 * wt.numel()


def tile_rows(args, kw):
    """Tile-list call (K2-K5): (rows, tiles, index bytes) of its lists,
    with the entries' defaults (every tile, lbase = tid * Lp, Lcall =
    Lp)."""
    meta, rays = args[1], args[2]
    T = rays.shape[0] // 64
    Lp = meta.shape[0] // T
    dev = rays.device
    tid = kw.get("tid")
    tid = torch.arange(T, device=dev) if tid is None else tid.long()
    lb = kw.get("lbase")
    lb = tid * Lp if lb is None else lb.long()
    ns = kw.get("nslots")
    ns = torch.full_like(tid, Lp) if ns is None else ns.long()
    k = torch.arange(kw.get("Lcall") or Lp, device=dev)
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


def device_events(run):
    """{device kernel name: (total ms, launches seen)} by torch.profiler
    while run() runs.  The profiler can miss launches (PERF.md), so a
    kernel's time is its mean over the launches seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def profiled_ms(ev, kernels):
    """Each named kernel's own device time per launch in device_events'
    ev: {name: (ms or None if the profiler saw no launch of it, launches
    seen)}.  A name matches every device kernel whose name contains it."""
    seen = {}
    for name in kernels:
        mine = [v for key, v in ev.items() if name in key]
        n = sum(c for _, c in mine)
        seen[name] = (sum(t for t, _ in mine) / n if n else None, n)
    return seen


def per_call_ms(ev, reps):
    """Device ms of one of the reps identical calls device_events saw:
    each kernel's mean per launch times its launches per call (its count
    over reps, rounded, at least 1)."""
    if not ev:
        return None
    return sum(t / n * max(1, round(n / reps)) for t, n in ev.values())


def kernel_device_ms(fn, calls, reps, kernel):
    """The kernel's own device time per launch, by torch.profiler, over
    reps runs of each recorded call: the wrapper's checks, the copy of
    init into the output and the launch gaps are not in it.  Returns
    (ms or None if the profiler saw no launch of it, launches seen)."""
    outs = [torch.empty_like(a[2][:, :8]) for a, _ in calls]
    for (a, k), o in zip(calls, outs):
        fn(*a, **k, out=o)                                  # warm

    def run():
        for (a, k), o in zip(calls, outs):
            for _ in range(reps):
                fn(*a, **k, out=o)
    return profiled_ms(device_events(run), [kernel])[kernel]


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


# kernel, its CUDA function, the TPU kernel it replaces, its rows
SPECS = {
    "brick_field_tiles_wl": ("brick_field_wl_kernel", f"{PALLAS}:936",
                             wl_rows),
    "brick_field_tiles_tp": ("brick_field_tp_kernel", f"{PALLAS}:692",
                             tile_rows),
    "brick_field_tiles": ("brick_field_n_kernel", f"{PALLAS}:242",
                          tile_rows),
    "brick_field_tiles_t": ("brick_field_t_kernel", f"{PALLAS}:469",
                            tile_rows),
    "brick_field_tiles_rgba": ("brick_field_rgba_kernel", f"{PALLAS}:1146",
                               tile_rows)}


def measure(bf, name, calls, request, launches, reps):
    """One kernel on every call its request made: held against the plain
    version (1e-4), its device time, wrapper time, plain time (one run of
    every call) and bound.  Returns the kernels-line entry."""
    kname, src, rows_of = SPECS[name]
    fn, plain_fn = getattr(bf, name), getattr(bf, name + "_plain")
    errs, works = [], []
    for a, k in calls:
        got = fn(*a, **k)
        errs.append(kernel_errors(got, plain_fn(*a, **k),
                                  f"{name} vs plain on a {request} call"))
        works.append(call_work(bf, a, k, got, *rows_of(a, k),
                               rgba=name == "brick_field_tiles_rgba",
                               lane_rows=LANE_ROWS.get(name, 0)))
    ms, seen = kernel_device_ms(fn, calls, reps, kname)
    call_ms = time_calls(fn, calls, reps=reps)
    ms_by = (f"profiler device time per launch ({seen} launches seen of "
             f"{reps * len(calls)})")
    if ms is None:                  # no device trace: the whole call
        ms, ms_by = call_ms, "CUDA events around the wrapper call"
    plain_ms = time_calls(plain_fn, calls, reps=1)
    mean = lambda key: sum(w[key] for w in works) / len(works)  # noqa: E731
    entry = dict(
        name=name, route="cuda",
        source=f"{CSRC}/brick_field_dense.cu",
        replaces=src,
        launches=launches, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=mean("bound_ms"),
        bound_by=max(works, key=lambda w: w["bound_ms"])["bound_by"],
        library_ms=None, request=request, ms_by=ms_by, wrapper_ms=call_ms,
        calls_timed=len(calls), samples_per_call=mean("samples"),
        live_slots_per_call=mean("live_slots"),
        distinct_voxels_per_call=mean("distinct_voxels"),
        bound_bytes_ms=mean("bound_bytes_ms"),
        bound_ops_ms=mean("bound_ops_ms"))
    print(f"{request}: {name}: kernel {ms:.4f} ms ({ms_by}), wrapper "
          f"{call_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{entry['bound_ms']:.5f} ms by {entry['bound_by']}, per call "
          f"over {len(calls)} calls; {launches} launches; max abs err "
          f"{max(errs):.2e}", flush=True)
    entry["modelled_pool_bytes_per_call"] = mean("modelled_pool_bytes")
    print(f"{request}: {name}: {entry['samples_per_call']:.0f} samples "
          f"and {entry['live_slots_per_call']:.1f} live slots per call; "
          f"bound by bytes {entry['bound_bytes_ms']:.5f} ms "
          f"({mean('bytes'):.0f} bytes, {entry['distinct_voxels_per_call']:.0f} "
          f"distinct voxels), by operations {entry['bound_ops_ms']:.5f} "
          f"ms; pool bytes the design requests, modelled: "
          f"{entry['modelled_pool_bytes_per_call']:.0f}", flush=True)
    return entry


# ------------------------------------------------- phase 8: the tool path

# probe: (the device ops of one wrapper call, its CUDA kernel first; the
# TPU kernel it replaces).  P3's call is its C entry's memset of the
# output and the kernel's adds.
PROBE_SPECS = {
    "gather_rows_f32": (("gather_rows_kernel",), "tools/pallas_probe.py:43"),
    "gather_rows_bf16": (("gather_rows_kernel",),
                         "tools/pallas_probe.py:78"),
    "scatter_add_rows": (("scatter_add_rows_kernel", "Memset (Device)"),
                         "tools/pallas_probe.py:124"),
    "gather_rows_bulk": (("gather_rows_bulk_kernel",),
                         "tools/pallas_probe.py:168")}


def bound_of(nbytes, ops, peak):
    """(bound ms, what binds it) of nbytes moved and ops done at peak."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rung_bound(ladder, k):
    """Rung k's bound on the tool's operands: the operand bytes it reads
    once and its (8, 64) f32 output written once; its elementwise
    operations at the f32 rate, or k8's and k10's products at the bf16
    tensor-core rate."""
    S, TPX, N, VOX, ROWW = (ladder.S, ladder.TPX, ladder.N, ladder.VOX,
                            ladder.ROWW)
    work = {1: (4 * 8 * TPX, 8 * TPX), 2: (4 * TPX, N), 3: (0, 4 * N),
            4: (0, S * TPX), 5: (0, 3 * N), 6: (0, 3 * VOX * N),
            7: (2 * VOX * N, 3 * VOX * N), 8: (2 * ROWW * VOX,
                                               2 * ROWW * VOX * N),
            9: (4 * 16 * TPX, 16 * N), 10: (2 * 64 * 32, 2 * 64 * 32 * N),
            11: (2 * 4 * ROWW * N, 3 * ROWW * N), 12: (4 * TPX, 3 * 8 * TPX),
            13: (0, 2 * ROWW * N), 14: (4 * (TPX + 1), 3 * N), 15: (12, 9),
            16: (0, 14 * N), 17: (2 * VOX * N, 2 * VOX * N)}
    nbytes, ops = work[k]
    return bound_of(nbytes + 4 * 8 * TPX, ops, H100_BF16_FLOPS
                    if k in (8, 10) else H100_F32_FLOPS)


def measure_probe(p, pid, launches, request, reps):
    """One probe (kernel_probe.Probe) on its inputs: held against its plain
    version, its device time (torch.profiler; P3's memset and kernel),
    wrapper time (CUDA events), plain time, the one-call PyTorch versions'
    times (CUDA events and profiler) and its bound.  Returns the
    kernels-line entry."""
    knames, src = PROBE_SPECS[p.name]
    ok, err = p.agrees(p.fn(*p.args), p.plain(*p.args))
    check(ok, f"{request}: {p.name} vs plain, max abs err {err}")
    ev = device_events(lambda: [p.fn(*p.args) for _ in range(reps)])
    ops = profiled_ms(ev, knames)
    wrapper_ms = cuda_ms(lambda: p.fn(*p.args), reps)
    # a call's device time: each of its ops' mean per launch, summed
    ms = None if any(v is None for v, _ in ops.values()) else sum(
        v for v, _ in ops.values())
    ms_by = ("profiler device time per call: " + ", ".join(
        f"{k} ({n} of {reps} seen)" for k, (_, n) in ops.items()))
    if ms is None:              # no device trace: the whole call
        ms, ms_by = wrapper_ms, "CUDA events around the wrapper call"
    # each one-call PyTorch version: CUDA events around the call, its
    # device time per call and the device kernels the profiler saw
    libraries = {}
    for lname, call in p.library_calls().items():
        lev = device_events(lambda: [call() for _ in range(reps)])
        libraries[lname] = dict(
            ms=cuda_ms(call, reps), device_ms=per_call_ms(lev, reps),
            device_kernels={k[:96]: n for k, (_, n) in lev.items()})
    library = min(libraries, key=lambda n: libraries[n]["ms"])
    bound_ms, bound_by = bound_of(*p.work(), H100_F32_FLOPS)
    return dict(
        name=p.name, id=pid, route="cuda", source=f"{CSRC}/probe.cu",
        replaces=src, launches=launches, max_abs_err=err, ms=ms,
        plain_ms=cuda_ms(lambda: p.plain(*p.args), reps),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=libraries[library]["ms"], library=library,
        libraries=libraries, request=request, ms_by=ms_by,
        wrapper_ms=wrapper_ms, kernel_ms=ops[knames[0]][0],
        # every device kernel of one call (P3's zero fill included)
        call_device_ms=per_call_ms(ev, reps), rows=p.rows)


def print_probe(e, tag):
    libs = "; ".join(f"{n} {v['ms']:.4f} ms (device {v['device_ms']} ms"
                     f" in {v['device_kernels']})"
                     for n, v in e.get("libraries", {}).items())
    print(f"{tag}: {e['id']} {e['name']}: device {e['ms']:.5f} ms "
          f"(kernel {e.get('kernel_ms', e['ms'])} ms), "
          f"wrapper {e['wrapper_ms']:.4f} ms (device "
          f"{e.get('call_device_ms')} ms), plain {e['plain_ms']:.4f} "
          f"ms, bound {e['bound_ms']:.5f} ms by {e['bound_by']}; "
          f"{e['launches']} launches; max abs err "
          f"{e['max_abs_err']:.2e}; library: {libs or None}", flush=True)


def phase8(seed, reps=50):
    """The tool path: kernel_probe and kernel_ladder through their entry
    points with every P counter at 0 just before (read just after); then
    each probe and rung against its plain version, with its device time
    (torch.profiler), wrapper time (CUDA events), plain time, library
    times (P1-P4: each one-call PyTorch version by CUDA events and by the
    profiler) and bound.  Returns the kernels-line entries."""
    from google_nerf_tpu_torch.ops.cuda import ladder, probe
    from google_nerf_tpu_torch.tools import kernel_ladder, kernel_probe
    probe.gather_rows.launches = {"float32": 0, "bfloat16": 0}
    probe.scatter_add_rows.launches = 0
    probe.gather_rows_bulk.launches = 0
    ladder.rung.launches = 0
    rcs = (kernel_probe.main(["--seed", str(seed)]), kernel_ladder.main([]))
    torch.cuda.synchronize()
    launches = {"gather_rows_f32": probe.gather_rows.launches["float32"],
                "gather_rows_bf16": probe.gather_rows.launches["bfloat16"],
                "scatter_add_rows": probe.scatter_add_rows.launches,
                "gather_rows_bulk": probe.gather_rows_bulk.launches,
                "ladder": ladder.rung.launches}
    check(rcs == (0, 0), f"phase 8: kernel_probe, kernel_ladder exited {rcs}")
    for name, n in launches.items():
        check(n > 0, f"phase 8: {name} not launched on the tool path")
    print(f"phase 8: tool path launches {launches}", flush=True)

    entries = [measure_probe(p, pid, launches[p.name], "kernel_probe", reps)
               for pid, p in zip(("P1", "P2", "P3", "P4"),
                                 kernel_probe.probes("cuda", seed))]

    ops = ladder.operands("cuda")
    rungs, errs = [], []
    for k in ladder.RUNGS:
        got, why = kernel_ladder.run_rung(k, ops)
        check(why is None, f"phase 8: rung k{k} vs plain: {why}")
        args = ladder.rung_operands(k, ops)
        want = ladder.rung_plain(k, *args)
        errs.append(float((got - want).abs().max()))
        rungs.append(dict(k=k, name=ladder.RUNGS[k][0], value=float(got[0, 0]),
                          wrapper_ms=cuda_ms(lambda: ladder.rung(k, *args),
                                             reps),
                          plain_ms=cuda_ms(lambda: ladder.rung_plain(k, *args),
                                           reps)))
        rungs[-1]["bound_ms"], rungs[-1]["bound_by"] = rung_bound(ladder, k)

    def every_rung():
        for k in ladder.RUNGS:
            args = ladder.rung_operands(k, ops)
            for _ in range(reps):
                ladder.rung(k, *args)
    seen = profiled_ms(device_events(every_rung),
                       [f"k{k}_kernel(" for k in ladder.RUNGS])
    for r in rungs:
        r["ms"] = seen[f"k{r['k']}_kernel("][0]
        if r["ms"] is None:
            r["ms"] = r["wrapper_ms"]
        print(f"phase 8: P5 {r['name']}: kernel {r['ms']:.5f} ms, wrapper "
              f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}", flush=True)
    total = lambda key: sum(r[key] for r in rungs)  # noqa: E731
    entries.append(dict(
        name="ladder", id="P5", route="cuda", source=f"{CSRC}/ladder.cu",
        replaces="tools/mosaic_bisect.py:21", launches=launches["ladder"],
        max_abs_err=max(errs), ms=total("ms"), plain_ms=total("plain_ms"),
        bound_ms=total("bound_ms"),
        bound_by=max(rungs, key=lambda r: r["bound_ms"])["bound_by"],
        library_ms=None, request="kernel_ladder",
        ms_by=("sum over the 17 rungs of each one's profiler device time "
               "per launch (CUDA events around the call where unseen)"),
        wrapper_ms=total("wrapper_ms"), rungs=rungs))
    for e in entries:
        print_probe(e, "phase 8")
    return entries


# ------------------------------------------ phases 9 and 10: training

# bench.py:113-117 (its model is phase 3's NGPConfig)
TRAIN_KW = dict(batch_size=8192, k_samples=256, num_epochs=30,
                samples_budget=57344, max_samples=512, grid_sample_div=16,
                random_bg=True, exclude_incomplete="backfill",
                march="block2")
TRAIN_STEPS = 1024          # bench.py's psnr@1024
TIMED_FROM = 512            # bench.py times steps 512-1023
PROFILE_STEP, SYNC_STEP = 400, 450      # both before the timed steps


def draws_of(gen, scene, cfg, dev):
    """One step's draws from gen: batch indices, backgrounds, noise."""
    n_img, n_pix = scene["images"].shape[:2]
    B = cfg.batch_size
    return dict(
        img_idxs=torch.randint(0, n_img, (B,), generator=gen, device=dev),
        pix_idxs=torch.randint(0, n_pix, (B,), generator=gen, device=dev),
        bg=torch.rand((B, 3), generator=gen, device=dev),
        noise=torch.rand((B,), generator=gen, device=dev))


def kernel_vs_plain_step(tsys, ph, probe, state, scene, cfg, draws):
    """One step's loss and gradients with P2/P3 and then with their plain
    versions, from one state, batch and set of draws: loss within rtol
    1e-6, every gradient but the table's within rtol 1e-6, the table's
    within 1e-6 x the sum of |payload| of its (row, column).  Returns
    (errors, the recorded P2 and P3 calls)."""
    batch = tsys.sample_batch(scene, cfg.batch_size,
                              img_idxs=draws["img_idxs"],
                              pix_idxs=draws["pix_idxs"])
    rec = {n: Recorder(getattr(ph, n)) for n in ("gather_rows",
                                                  "scatter_add_rows")}
    for n, r in rec.items():
        setattr(ph, n, r)
    try:
        lk, _, gk = tsys.loss_and_grads(state, scene, batch, cfg,
                                        draws=draws)
    finally:
        for n, r in rec.items():
            setattr(ph, n, r.fn)
    for n in rec:
        setattr(ph, n, getattr(probe, n + "_plain"))
    try:
        lp, _, gp = tsys.loss_and_grads(state, scene, batch, cfg,
                                        draws=draws)
    finally:
        for n, r in rec.items():
            setattr(ph, n, r.fn)
    torch.cuda.synchronize()
    check(len(rec["gather_rows"].calls) == 1
          and len(rec["scatter_add_rows"].calls) == 1,
          "phase 9: the step did not make one P2 and one P3 call")
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    check(loss_err <= 1e-6, f"phase 9: kernel step loss {float(lk)} vs "
          f"plain {float(lp)}")
    errs = dict(loss_rel=loss_err)
    for k in gp:
        if k == "packed_table":
            continue
        ok = bool(((gk[k] - gp[k]).abs() <= 1e-6 * gp[k].abs()).all())
        errs[k] = float((gk[k] - gp[k]).abs().max())
        check(ok, f"phase 9: gradient {k} kernel vs plain beyond rtol 1e-6"
              f" (max abs {errs[k]})")
    sidx, vals, T = rec["scatter_add_rows"].calls[0][0]
    mag = probe.scatter_add_rows_plain(sidx, vals.abs(), T).view_as(gp[
        "packed_table"])
    d = (gk["packed_table"] - gp["packed_table"]).abs()
    check(bool((d <= 1e-6 * mag).all()), "phase 9: table gradient kernel "
          f"vs plain beyond 1e-6 x sum|payload| (max abs {float(d.max())})")
    errs["packed_table"] = float(d.max())
    return errs, rec


def phase9(seed, dev, steps=TRAIN_STEPS):
    """bench.py's training loop at full width from --seed: the textured
    scene, the grid cadence, fused steps; checks and timings as the
    module notes say.  Returns (state, cfg, summary, kernels-line
    entries)."""
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    from google_nerf_tpu_torch.ops import packed_hash as ph
    from google_nerf_tpu_torch.ops.cuda import probe
    from google_nerf_tpu_torch.tools.kernel_probe import Probe
    from google_nerf_tpu_torch.train import system as tsys
    cfg = tsys.TrainConfig(model=NGPConfig(
        scale=0.5, encoder="packed", grid_size=128,
        compute_dtype=torch.bfloat16), **TRAIN_KW)
    torch.cuda.synchronize()
    t0 = time.time()
    ds = SyntheticDataset(split="train", n_images=40, img_wh=(256, 256),
                          style="textured", device=dev)
    scene = ds.scene()
    state = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                                  generator=torch.Generator().manual_seed(
                                      seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"phase 9: scene and state in {setup_s:.1f} s", flush=True)
    probe.gather_rows.launches = {"float32": 0, "bfloat16": 0}
    probe.scatter_add_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log, prof = {}, None
    t_start = time.time()
    for i in range(steps):
        if i == TIMED_FROM:
            torch.cuda.synchronize()
            t_timed = time.time()
        if i % cfg.grid_update_interval == 0:
            tsys.grid_update_step(state, cfg, warmup=i < cfg.warmup_steps,
                                  generator=gen)
        step = lambda: tsys.fused_train_step(  # noqa: E731
            state, scene, cfg, generator=gen)
        if i == PROFILE_STEP:
            out = []
            prof = profile_frame(lambda: out.append(step()))
            metrics = out[0][1]
        elif i == SYNC_STEP:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, metrics = step()
            except RuntimeError as e:
                check(False, f"phase 9: step {i} synced the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            _, metrics = step()
        if (i + 1) % 64 == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            check(math.isfinite(m["loss"]), f"phase 9: loss {m['loss']} "
                  f"at step {i + 1}")
            log[i + 1] = m
            print(f"phase 9: step {i + 1}: " + " ".join(
                f"{k}={v:.5g}" for k, v in m.items())
                + f"; {time.time() - t_start:.1f} s", flush=True)
    torch.cuda.synchronize()
    timed_s = time.time() - t_timed
    launches = {"gather_rows_bf16": probe.gather_rows.launches["bfloat16"],
                "scatter_add_rows": probe.scatter_add_rows.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_timed = steps - TIMED_FROM
    ms_step = 1e3 * timed_s / n_timed
    occ_frac = float(state["occ"].float().mean())
    psnr_end = log[steps]["psnr"]
    summary = dict(
        steps=steps, setup_s=setup_s, train_s=time.time() - t_start,
        ms_per_step=ms_step, rays_per_s=n_timed * cfg.batch_size / timed_s,
        psnr_512=log.get(512, {}).get("psnr"), psnr_end=psnr_end,
        s_per_ray=log[steps]["s_per_ray"],
        mask_frac=log[steps]["mask_frac"], occ_frac=occ_frac,
        peak_gib=peak_gib, launches=launches, profiled_step=prof,
        log=log)
    print(f"phase 9: {steps} steps; steps {TIMED_FROM}-{steps - 1}: "
          f"{ms_step:.3f} ms/step, {summary['rays_per_s']:.1f} rays/s; "
          f"psnr@512 {summary['psnr_512']}, psnr@{steps} {psnr_end:.3f}; "
          f"occupancy {occ_frac:.4f}; peak {peak_gib:.2f} GiB; launches "
          f"{launches}; profiled step {prof}", flush=True)
    check(psnr_end >= 45.0, f"phase 9: train psnr {psnr_end} < 45 dB")
    check(0.001 < occ_frac < 0.5, f"phase 9: occupancy {occ_frac}")
    for k, n in launches.items():
        check(n > 0, f"phase 9: {k} not launched in training")

    errs, rec = kernel_vs_plain_step(tsys, ph, probe, state, scene, cfg,
                                     draws_of(gen, scene, cfg, dev))
    summary["kernel_vs_plain_step"] = errs
    print(f"phase 9: kernel step vs plain step {errs}", flush=True)
    (tab, idx), _ = rec["gather_rows"].calls[0]
    (sidx, vals, T), _ = rec["scatter_add_rows"].calls[0]
    n = idx.numel()
    entries = []
    for pid, p in (
            ("P2", Probe("train", "gather_rows_bf16",
                         f"the encoder's row gather, {n} x 16 bf16",
                         probe.gather_rows, probe.gather_rows_plain,
                         (tab, idx), n)),
            ("P3", Probe("train", "scatter_add_rows",
                         f"the table gradient, {n} x 16 f32 onto {T} rows",
                         probe.scatter_add_rows,
                         probe.scatter_add_rows_plain, (sidx, vals, T), n,
                         scatter=True))):
        entries.append(measure_probe(p, pid, launches[p.name], "train",
                                     reps=50))
        print_probe(entries[-1], "phase 9")
    return state, cfg, summary, entries


def trained_frame_errors(got, want, limit=1e-4, flip_limit=2e-3,
                         flip_share=1e-4):
    """The trained frame against its plain frame: opacity within `limit`
    per pixel and the counters equal, as frame_errors; rgb within `limit`
    per pixel but at most flip_share of the pixels, which may differ by
    up to flip_limit.  K1's MLP sums its bf16 products on mma.sync in
    another order than the plain f32 product, which can round a hidden
    activation to the neighbouring bf16 value; on trained weights such a
    flip moves a pixel's rgb past 1e-4 (it stays under 1e-5 on phase 3's
    random weights).  flip_limit is JAX's tolerance for two kernels whose
    weights differ in the last bit (n512 vs t512).  Returns (rgb MAE, rgb
    max, opacity max, pixels past limit)."""
    d_rgb = (got["rgb"] - want["rgb"]).abs().amax(-1)
    d_op = float((got["opacity"] - want["opacity"]).abs().max())
    over = int((d_rgb > limit).sum())
    errs = (float(d_rgb.mean()), float(d_rgb.max()), d_op, over)
    check(d_op <= limit, f"trained wl256: opacity max {d_op} > {limit}")
    check(over <= flip_share * d_rgb.numel() and errs[1] <= flip_limit,
          f"trained wl256: rgb max {errs[1]}, {over} pixels past {limit} "
          f"(at most {flip_share * d_rgb.numel():.0f}, each within "
          f"{flip_limit})")
    for k in COUNTERS:
        check(int(got[k]) == int(want[k]), f"trained wl256: {k} "
              f"{int(got[k])} vs {int(want[k])}")
    return errs


def phase10(state, cfg, o, d, gt, dev):
    """Serve the trained state: 256^3 bake, the wl256 request on phase
    3's pose, the kernel frame against the plain frame, PSNR against
    ground truth."""
    import google_nerf_tpu_torch.models.render_brick_mxu as rbm
    from google_nerf_tpu_torch.eval.metrics import psnr
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.ops.cuda import brick_field as bf
    m = cfg.model
    params = {k: ([w.detach() for w in v] if isinstance(v, list)
                  else v.detach()) for k, v in state["params"].items()}
    bcfg = BakedConfig(voxel_res=256, block=8, dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.time()
    baked = bake(params, m, state["occ"], bcfg, device=dev)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    geo = brick_geometry(baked["block_map"], bcfg, m)

    def serve(**over):
        return rbm.render_brick_mxu(baked, m, o, d, 800, 800, bcfg=bcfg,
                                    geometry=geo, device=dev,
                                    **dict(SERVE_KW, **over))

    frame, _, launches = run_request(rbm, bf, "brick_field_tiles_wl", serve)
    check_frame(frame, "trained wl256", 800 * 800)
    check(int(frame["pairs_undrained"]) == 0,
          "trained wl256 left pairs undrained")
    check(launches["brick_field_tiles_wl"] > 0,
          "K1 not launched on the trained wl256 request")
    check(launches["brick_field_tiles_tp"] > 0,
          "K2 (drain) not launched on the trained wl256 request")
    plain = plain_frame(rbm, bf, ("brick_field_tiles_wl",
                                  "brick_field_tiles_tp"), serve)
    errs = trained_frame_errors(frame, plain)
    p = float(psnr(frame["rgb"], gt))
    times = frame_ms(serve, 3)
    out = dict(bake_s=bake_s, n_blocks=int(baked["n_blocks"]),
               counters=counters_of(frame), launches=launches, psnr=p,
               frame_ms=times, plain_frame_err=errs,
               mean_opacity=float(frame["opacity"].mean()))
    print(f"phase 10: trained wl256: {out}", flush=True)
    check(p >= 40.0, f"phase 10: trained wl256 psnr {p} < 40 dB")
    return out


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
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    from google_nerf_tpu_torch.models.baked_rgba import (
        bake_rgba, render_brick_mxu_rgba)
    from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.ops.cuda import _build
    from google_nerf_tpu_torch.ops.cuda import brick_field as bf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1: card and build
    card = card_line()
    print(card, flush=True)            # name, power limit as nvidia-smi says

    t0 = time.time()
    libs = _build.build("brick_field_dense", "probe",
                        "ladder")                      # nvcc in parallel
    build_s = time.time() - t0
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        print(f"phase 1: built {lib.name} in {build_s:.1f} s; "
              + "; ".join(l.split("info    : ")[-1] for l in log.splitlines()
                          if "registers" in l or "spill" in l), flush=True)

    # ---- 2: kernels against plain versions at serving widths
    errs2 = phase2(bf, args.seed, dev)
    print(f"phase 2: kernels vs plain and golden at serving widths, max abs "
          f"err {errs2}", flush=True)

    # ---- 3: the wl256 request at full width
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

    frame, wl_calls, launches_a = run_request(rbm, bf,
                                              "brick_field_tiles_wl", serve)
    check_frame(frame, "wl256", 800 * 800)
    check(int(frame["pairs_undrained"]) == 0, "wl256 left pairs undrained")
    check(launches_a["brick_field_tiles_wl"] > 0,
          "K1 not launched on the wl256 request")
    check(launches_a["brick_field_tiles_tp"] > 0,
          "K2 (drain) not launched on the wl256 request")
    print(f"phase 3: wl256 {counters_of(frame)}; launches {launches_a}; "
          f"mean opacity {float(frame['opacity'].mean()):.4f}", flush=True)

    # ---- 4: the same frame through the plain versions
    plain = plain_frame(rbm, bf, ("brick_field_tiles_wl",
                                  "brick_field_tiles_tp"), serve)
    mae, dmax, dop = frame_errors(frame, plain, "wl256 kernel frame vs plain")
    print(f"phase 4: plain frame rgb MAE {mae:.3e}, rgb max diff "
          f"{dmax:.3e}, opacity max diff {dop:.3e}", flush=True)

    # ---- 5: a budget cut below the segment load, so the drain runs
    real_groups = int((wl_calls[0][0][10] > 0).sum())
    cut = max(real_groups - 40, 1)
    drained, _, launches_b = run_request(
        rbm, bf, "brick_field_tiles_tp", lambda: serve(wl_cap=cut))
    check(launches_b["brick_field_tiles_tp"] > 0,
          "K2 (drain) not launched with the budget cut")
    dmae = float((drained["rgb"] - frame["rgb"]).abs().mean())
    print(f"phase 5: wl_cap {cut} (segment-0 load {real_groups} groups): "
          f"{counters_of(drained)}; launches {launches_b}; rgb MAE vs uncut "
          f"{dmae:.3e}", flush=True)
    if int(drained["pairs_undrained"]) == 0:
        frame_errors(drained, frame, "drained frame vs uncut",
                     counters=("pairs_rendered",))

    # ---- 6: wl256 timings; K1 on every call of the request
    torch.cuda.reset_peak_memory_stats()
    wl_ms = frame_ms(serve, 3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = profile_frame(serve)
    print(f"phase 6: wl256 warm frames {wl_ms} ms; peak memory "
          f"{peak_gib:.2f} GiB; profiled frame: {breakdown}", flush=True)
    kernels = [measure(bf, "brick_field_tiles_wl", wl_calls, "wl256",
                       launches_a["brick_field_tiles_wl"], reps=20)]

    # ---- 7: the 512^3 bake and the per-chunk requests
    del baked, geo, plain, drained
    bcfg5 = BakedConfig(voxel_res=512, block=8, dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.time()
    baked5 = bake(params, cfg, occ, bcfg5, device=dev)
    torch.cuda.synchronize()
    bake5_s = time.time() - t0
    geo5 = brick_geometry(baked5["block_map"], bcfg5, cfg)
    baked5_blocks = int(baked5["n_blocks"])
    print(f"phase 7: baked 512^3: {baked5['n_blocks']} bricks in "
          f"{bake5_s:.2f} s", flush=True)

    def render(kw):
        def go():
            if kw is RGBA512:
                return render_brick_mxu_rgba(
                    baked5, cfg, o, d, 800, 800, bcfg=bcfg5, geometry=geo5,
                    device=dev, **kw)
            return rbm.render_brick_mxu(baked5, cfg, o, d, 800, 800,
                                        bcfg=bcfg5, geometry=geo5,
                                        device=dev, **kw)
        return go

    requests = (("tp512", TP512, "brick_field_tiles_tp"),
                ("t512", T512, "brick_field_tiles_t"),
                ("n512", dict(T512, kernel="n"), "brick_field_tiles"),
                ("rgba512", RGBA512, "brick_field_tiles_rgba"))
    summary, frames = {}, {}
    for request, kw, name in requests:
        go = render(kw)
        t0 = time.time()
        fr, calls, launches = run_request(rbm, bf, name, go)
        first_s = time.time() - t0
        check_frame(fr, request, 800 * 800)
        check(launches[name] > 0, f"{name} not launched on {request}")
        if request in ("tp512", "rgba512"):   # exact by construction
            check(int(fr["pairs_undrained"]) == 0,
                  f"{request} left pairs undrained")
        t0 = time.time()
        pl = plain_frame(rbm, bf, (name,), go)
        plain_s = time.time() - t0
        errs = frame_errors(fr, pl, f"{request} kernel frame vs plain")
        print(f"{request}: {counters_of(fr)}; launches {launches}; mean "
              f"opacity {float(fr['opacity'].mean()):.4f}; first frame "
              f"{first_s:.2f} s, plain frame {plain_s:.2f} s; vs plain: rgb "
              f"MAE {errs[0]:.3e} max {errs[1]:.3e}, opacity max "
              f"{errs[2]:.3e}", flush=True)
        times = frame_ms(go, 3)
        prof = profile_frame(go)
        kernels.append(measure(bf, name, calls, request, launches[name],
                               reps=3))
        summary[request] = dict(counters=counters_of(fr), launches=launches,
                                frame_ms=times, profile=prof,
                                plain_frame_s=plain_s, plain_frame_err=errs)
        frames[request] = {k: fr[k] for k in ("rgb", "opacity") + COUNTERS}
        print(f"{request}: warm frames {times} ms; profiled frame {prof}",
              flush=True)
        del pl, calls
    nt = frame_errors(frames["n512"], frames["t512"], "n512 vs t512",
                      limit=2e-3, counters=("pairs_rendered",))
    torch.cuda.synchronize()
    t0 = time.time()
    bake_rgba(baked5, cfg, bcfg5, o[0])
    torch.cuda.synchronize()
    rgba_bake_ms = 1e3 * (time.time() - t0)
    print(f"phase 7: n512 vs t512 rgb MAE {nt[0]:.3e} max {nt[1]:.3e}; "
          f"per-frame rgba bake {rgba_bake_ms:.2f} ms", flush=True)

    kernels = sorted(kernels, key=lambda e: KERNELS.index(e["name"]))
    kernels[KERNELS.index("brick_field_tiles_tp")]["launches_wl256"] = \
        launches_a["brick_field_tiles_tp"]
    kernels += phase8(args.seed)
    gt = torch.as_tensor(ds.rays[0], device=dev)
    del baked5, geo5, frames
    torch.cuda.empty_cache()

    # ---- 9: train bench.py's recipe; 10: serve the trained state
    state, tcfg, train, train_kernels = phase9(args.seed, dev)
    kernels += train_kernels
    served = phase10(state, tcfg, o, d, gt, dev)
    print(f"card {card}; bake 256^3 {bake_s:.3f} s, 512^3 {bake5_s:.3f} s; "
          f"wl256 median {statistics.median(wl_ms):.2f} ms; " + "; ".join(
              f"{r} median {statistics.median(s['frame_ms']):.2f} ms"
              for r, s in summary.items())
          + f"; train {train['ms_per_step']:.3f} ms/step, psnr@"
          f"{train['steps']} {train['psnr_end']:.2f}; trained wl256 psnr "
          f"{served['psnr']:.2f}, median "
          f"{statistics.median(served['frame_ms']):.2f} ms; total "
          f"{time.time() - t_start:.0f} s", flush=True)

    result = dict(card=card, seed=args.seed, bake_s=bake_s,
                  bake512_s=bake5_s, n_blocks_512=int(baked5_blocks),
                  wl256=dict(frame_ms=wl_ms, peak_gib=peak_gib,
                             counters=counters_of(frame),
                             launches=launches_a, profile=breakdown,
                             plain_frame_err=[mae, dmax, dop]),
                  requests=summary, n512_vs_t512=nt,
                  rgba_bake_ms=rgba_bake_ms, phase2_err=errs2,
                  train=train, trained_wl256=served, kernels=kernels)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    # P5's rungs and the modelled pool bytes of K1-K5 are in --out's JSON
    # only
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k not in OFF_LINE} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
