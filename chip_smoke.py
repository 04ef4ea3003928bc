"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed N] [--out result.json]

Phases:
  1. print the card (nvidia-smi name, power limit); build the kernels
     and the host libraries (the image codec, the .sens decoder);
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
     warm frame ms;
 11. bench.py's serving stages on the trained state, through
     bench_torch.py's stage functions and settings, in bench.py's order:
     bake (512^3), mxu (K2, tp512), mxu_v256 (K1, wl256), brick (the pair
     renderer, no kernel), oneshot (the live field, its encoder's gather
     on P2), baked_oneshot and mixed (the mixed bake padded to 4096
     bricks, K1), each with the K1, K2 and P2 counters at 0 just before
     it (read just after); per stage its warm frame ms, PSNR against
     ground truth and counters, and the checks in phase11's notes.  K2
     on the mxu frame's calls, K1 on the mixed frame's and P2 on the
     one-shot frame's largest gather join the kernels line (requests
     "trained mxu", "trained mixed", "oneshot"); then LPIPS-vgg of the
     mxu frame against ground truth under the scope eval/metrics.py had
     (cuDNN off) and under exact_f32 (cuDNN on, TF32 off), both times;
 12. the CLIs as a user runs them (train_torch.main, then
     test_torch.run, in a temporary directory): training at opt.py's
     defaults (f32, the seg march, budget 16 x batch) on the textured
     scene at 256^2 for 1024 steps (the only cuts: depth), with P2 and
     P3; --val_only on its full checkpoint; serving it with oneshot,
     fast and brick_mxu (tp on a 512^3 bake) at 256^2, and with oneshot
     over the bake and brick_mxu on 10 test views at 800^2; checks and
     kernels-line
     entries ("cli train", "cli oneshot", "cli fast", "cli brick_mxu")
     in phase12's notes;
 13. datasets on disk through the CLIs (phase13's notes): an NSVF
     Synthetic-layout scene of 800x800 RGBA PNGs trained by
     train_torch.py at opt.py's defaults (512 steps, as each run of
     this phase) and served by test_torch.py; a
     ScanNet-layout scene (1296x968 JPEGs from the port's encoder, a
     metric frame, the mesh AABB, 16-bit PNG depth priors in mm) trained
     by train_scannet_torch.py at 640x480 with and without the priors,
     the supervised checkpoint served; decode, training and serving
     checks; P2/P3 of the NSVF and supervised ScanNet training steps on
     the kernels line (requests "nsvf", "scannet").  The image codec
     (csrc/image_codec.c) builds in phase 1 with the host C compiler;
 14. the other encoders and the block marcher through the CLIs (phase14's
     notes): phase 12's training run (1024 steps for hash, 512 for the
     others) with --xyz_encoder hash, freq or
     packed2, or --march block, then test_torch.py's oneshot on each
     checkpoint (block serving on the block rows); validate >= 25 dB
     (freq: above its train psnr at step 64); the kernel step against
     the plain step for hash and packed2; the hash-grid kernels (hash)
     and P2/P3 (packed2, P2 on the bf16 table padded to 72 columns) on
     the kernels line (requests "hash", "packed2");
 15. the depth-prior path (phase15's notes): depth_eval_scannet_torch.py
     at the CLIs' defaults (LeReS ResNeXt101-32x8d, encoder-site cIMLE at
     d_latent 32, crop 448; random weights from --seed saved as JAX's
     .npz) with 10 hypotheses a frame on phase 13's 28 ScanNet frames,
     its PNG priors as ground truth; the priors and their minibatch
     minima, a card forward against the CPU's (norm-relative 1e-4), the
     latents' spread, the priors read by ScannetDataset, the metric
     battery; ms a frame, images/s, GFLOP an image and its share of the
     f32 peak, peak memory.  The decoder's 3x3s run the repo's f32
     implicit-GEMM kernels (ops/cuda/conv3x3; the CLI's frames must
     launch them), timed at two shapes split over K (14^2, 28^2), the
     1/4 FFMs' and the AO head's beside cuDNN's F.conv2d (library_ms),
     held to their plain version, C3 on the kernels line; the rest of
     the network is cuDNN's convolutions in f32 with TF32 off, as JAX's
     reference leaves it to XLA;
 16. the cIMLE depth trainer (phase16's notes): depth_train_torch.py at
     the CLI's defaults (ResNeXt101-32x8d, encoder-site AdaIN at d_latent
     32, crop 448, batch 2, 20 latents an image at the recache) on 4
     frames of phase 13's scan for 2 epochs, --resume from epoch 1, one
     full-width step on the card against the CPU (and float64), and
     depth_eval_torch.py --num_samples 10 --select loss on its final.npz
     over 2 more frames; ms a step, recache ms, GFLOP, peak memory; the
     recache and the evaluation (no gradient) must launch the decoder's
     3x3 kernels, the step keeps nn.Conv2d;
 17. the .sens chain (phase17's notes): phase 13's 28 frames packed into
     a v4 .sens by the port's write_sens (1296x968 colour JPEGs, 640x480
     zlib depth in mm, depth_shift 1000), decoded (the header; the
     native batch zlib decode, csrc/sens_decode.cpp, against Python's
     zlib), exported by process_scene at 640x480 (frame skip 1: the scan
     holds 28 frames) and split by split_train_test; ScannetDataset on
     the export with its depth PNGs as the priors; train_scannet_torch.py
     with those priors for 512 steps (P2/P3), the kernel step against the
     plain step;
     decode ms a frame, export s, ms a step, validate PSNR, depth MAE;
     P2/P3 on the kernels line (request "sens chain");
 18. the shape refiner (phase18's notes): depth_shape_torch.py at its
     defaults (ResNeXt101 at crop 448, the SPVCNN heads at random init
     from the CLI's seeds) on two of phase 13's 1296x968 frames; then
     the refinement's three SPVCNN calls on the card against the CPU,
     both in exact_f32, on the same voxelized clouds (rel 1e-4); active
     sites per level, ms per spvcnn_apply, peak memory; the CLI's priors
     must launch the decoder's 3x3 kernels.
 19. data parallel (parallel/, phase19's notes) at bench.py's recipe
     from phase 9's trained state: NCCL at a world of one in this
     process (the DP step against the fused step on the same draws:
     loss and every gradient but the table's rtol 1e-6, the table within
     P3_SUM_C of the float64 sum of its payloads; the sharded grid update
     bit for bit; the DP one-shot, fast and brick frames at 800^2 against
     the serial frames, 1e-4 a pixel, the brick telemetry equal; ms a DP
     step against the plain step, in turns), then a gloo world of two
     spawned processes sharing the card (launch.run_world, a join
     timeout): 16 DP steps with the params and Adam moments bit-identical
     across the ranks, one step's reduced gradients against the serial
     mean of the two shards' (the table within P3_SUM_C of the float64
     mean), the grid update bit for bit, the three DP renderers against
     the serial frames, the multi-scene step on two procedural scenes
     (seeds 0 and 1) against a lone step each, SyncBN at resnet18 64^2
     (two images a rank) against the unsharded train-mode forward
     (norm-relative 1e-4 in float32, 1e-9 in float64, the running
     statistics too); ms a step at world 2 (two ranks on one card: not a
     scaling figure), bytes all-reduced a step; P2/P3 of the phase's DP
     step on the kernels line (request "dp"), their launches over the
     whole phase (this process's DP path and both ranks').
 20. RTMV from OpenEXR frames (phase20's notes): an RTMV-layout scene
     (the bricks subset's) of 110 views at 1600^2 of the textured scene,
     ZIP-compressed HALF RGBA frames (tools/exr_fixture.py), every frame
     decoded back bit for bit and one frame's decode timed; then
     train_torch.main --dataset_name rtmv at opt.py's defaults for
     DATA_STEPS steps (P2/P3), validate >= 25 dB, test_torch.run's
     default renderer within 1 dB of validate, the kernel step against
     the plain step (phase 9's bounds); P2/P3 on the kernels line
     (request "rtmv"); the phase's seconds, the writer's share, peak host
     and card memory.
 21. COLMAP from JPEG frames of every mode (phase21's notes): a COLMAP
     scene (sparse/0's cameras.bin, images.bin, points3D.bin on the
     object's surface; tools/colmap_fixture.py) of 24 views at 1008x756
     (LLFF's images_4) of the textured scene, the frames written by
     tools/jpeg_fixture.py in turn as Huffman 4:4:0, arithmetic 4:2:0,
     arithmetic progressive 4:2:0 and lossless; every arithmetic frame
     decoded bit for bit to its Huffman twin, every lossless frame to
     the pixels, one decode of each mode timed; then train_torch.main
     --dataset_name colmap at opt.py's defaults (--downsample 1.0) for
     COLMAP_STEPS steps (P2/P3), validate >= 25 dB, test_torch.run's
     default renderer within 1 dB of validate, the kernel step against
     the plain step (phase 9's bounds); P2/P3 on the kernels line
     (request "colmap"); the phase's seconds, the writer's seconds, peak
     host and card memory.

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
copies bytes, so both runs compute the same values); the kernel step's
table gradient within P3_SUM_C sqrt(n) 2^-24 x the sum of |payload| of
each (row, column) of the float64 sum of the same payloads, for a row of
n payloads (the plain step's table gradient is an atomic f32 sum too, in
its own order: held against it, two roundings add up).  Phase 14's
kernel steps (hash, packed2) and those of phases 17, 20 and 21 are held
to the same bounds.  Phase 20's frames decode to the HALF samples
written, bit for bit; phase 21's arithmetic frames to their Huffman
twins' samples and its lossless frames to the pixels, bit for bit.  Phase
10's frame against its plain frame: opacity 1e-4 per pixel and the
counters equal; rgb 1e-4 per pixel on all but 0.01% of the pixels,
which may differ by up to 2e-3
(a bf16 hidden activation rounded the other way after mma.sync's sum,
see trained_frame_errors).  Phase 11: the mxu and mixed frames against
their plain frames and their kernels' calls against the plain versions
at phase 10's trained rule (tau and depth 1e-4 everywhere).
Any failed check exits nonzero before the result
line.  The last stdout line is the result JSON; the line before it lists
every kernel with its times and its launches in its request (counters
reset just before the request, read just after; each kernel must have
launched there).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

import bench_torch
from bench_torch import card_line
from google_nerf_tpu_torch.tools.brick_inputs import serving_width_inputs
from google_nerf_tpu_torch.tools.kernel_probe import (P3_SUM_C, cuda_ms,
                                                      device_ms, named_ms,
                                                      p3_sum_bound)
from portbench.lib.work import PEAKS, bound_s

PALLAS = "google_nerf_tpu/ops/pallas/brick_field.py"
CSRC = "google_nerf_tpu_torch/csrc"
SERVE_KW = bench_torch.SETTINGS["v256"]     # bench.py:327-330
TP512 = bench_torch.SETTINGS["mxu"]         # bench.py:284-288
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


def kernel_errors(got, want, what="kernel vs plain", trained=False):
    """Max abs error over tau, rgb, depth; raises unless it is within
    atol 1e-4 and n_pairs are equal.  trained: a call on trained weights,
    where a ray's rgb may differ by up to 2e-3 (a bf16 hidden activation
    rounded the other way after mma.sync's sum, see
    trained_frame_errors); tau and depth, which no MLP touches, stay
    within 1e-4.  Returns (the max abs error, the rays whose rgb is past
    1e-4), the second for the caller to bound over a request."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: output not finite")
    err = float((g[:, :5] - w[:, :5]).abs().max())
    over = 0
    if trained:
        over = int(((g[:, 1:4] - w[:, 1:4]).abs().amax(1) > 1e-4).sum())
        check(err <= 2e-3, f"{what}: rgb error {err} > 2e-3")
        td = float((g[:, [0, 4]] - w[:, [0, 4]]).abs().max())
        check(td <= 1e-4, f"{what}: tau/depth error {td} > 1e-4")
    else:
        check(err <= 1e-4, f"{what}: tau/rgb/depth error {err} > 1e-4")
    check(torch.equal(g[:, 5], w[:, 5]), f"{what}: n_pairs differ")
    return err, over


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
                                   f"{name} vs plain (phase 2)")[0]
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
    """Wraps a kernel wrapper in the module that calls it: records a
    snapshot of the inputs (init is cloned: the frame updates in place)
    of every call (keep "all"), of its first `first` calls, of its
    largest (by the size of args[arg]) or of its last; with `gate`, only
    of the calls made while gate() is true.  Every call goes through; `n`
    counts them."""

    def __init__(self, fn, keep="all", arg=1, first=8, gate=None):
        self.fn, self.keep, self.arg, self.first = fn, keep, arg, first
        self.gate, self.calls, self.n = gate, [], 0

    def __call__(self, *args, **kw):
        self.n += 1
        if self.gate is None or self.gate():
            snap = dict(kw)
            if snap.get("init") is not None:
                snap["init"] = snap["init"].clone()
            snap.pop("out", None)
            if self.keep == "all" or (self.keep == "first"
                                      and len(self.calls) < self.first):
                self.calls.append((args, snap))
            elif self.keep == "last" or (
                    self.keep == "largest" and (
                        not self.calls or args[self.arg].numel()
                        > self.calls[0][0][self.arg].numel())):
                self.calls = [(args, snap)]
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
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = flops / PEAKS["flops_per_s"]["bfloat16"]
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


def kernel_device_ms(fn, calls, reps, kernel):
    """The kernel's own device time per launch, by torch.profiler, over
    reps runs of each recorded call: the wrapper's checks, the copy of
    init into the output and the launch gaps are not in it.  Returns
    (ms or None if the profiler saw no launch of it, launches seen)."""
    outs = [torch.empty_like(a[2][:, :8]) for a, _ in calls]

    def run():
        for (a, k), o in zip(calls, outs):
            for _ in range(reps):
                fn(*a, **k, out=o)
    return named_ms(device_ms(run, 1)[1], [kernel])[kernel]


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


PLAIN_CALLS = 16     # calls the plain version is timed on (every call is
                     # held against it)


def measure(bf, name, calls, request, launches, reps, trained=False):
    """One kernel on every call its request made: held against the plain
    version (1e-4; on trained weights kernel_errors' trained rule, with
    the rays past 1e-4 in rgb over all the calls at most 0.01% of an
    800x800 frame's, as trained_frame_errors allows the frame), its
    device time, wrapper time, plain time (one run of each of the first
    PLAIN_CALLS calls) and bound.  Returns the kernels-line entry."""
    kname, src, rows_of = SPECS[name]
    fn, plain_fn = getattr(bf, name), getattr(bf, name + "_plain")
    errs, works, flips = [], [], 0
    for a, k in calls:
        got = fn(*a, **k)
        err, over = kernel_errors(got, plain_fn(*a, **k),
                                  f"{name} vs plain on a {request} call",
                                  trained)
        errs.append(err)
        flips += over
        works.append(call_work(bf, a, k, got, *rows_of(a, k),
                               rgba=name == "brick_field_tiles_rgba",
                               lane_rows=LANE_ROWS.get(name, 0)))
    check(flips <= 1e-4 * 800 * 800, f"{name} vs plain on the {request} "
          f"calls: {flips} rays past 1e-4 in rgb")
    ms, seen = kernel_device_ms(fn, calls, reps, kname)
    call_ms = time_calls(fn, calls, reps=reps)
    ms_by = (f"profiler device time per launch ({seen} launches seen of "
             f"{reps * len(calls)})")
    if ms is None:                  # no device trace: the whole call
        ms, ms_by = call_ms, "CUDA events around the wrapper call"
    plain_ms = time_calls(plain_fn, calls[:PLAIN_CALLS], reps=1)
    mean = lambda key: sum(w[key] for w in works) / len(works)  # noqa: E731
    entry = dict(
        name=name, route="cuda",
        source=f"{CSRC}/brick_field_dense.cu",
        replaces=src,
        launches=launches, max_abs_err=max(errs), rgb_flips=flips, ms=ms,
        plain_ms=plain_ms,
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
    t, by = bound_s(nbytes + 4 * 8 * TPX, ops,
                    "bfloat16" if k in (8, 10) else "float32")
    return 1e3 * t, by


def kernel_row(tag, fn, plain, kernels, work, *, reps, plain_reps=None,
               libraries=None, **row):
    """One per-call row of the kernels line, printed under `tag`: fn()
    (the wrapper call) and plain() (its plain version) on the inputs the
    caller has held them to.  wrapper_ms: fn by CUDA events over reps
    calls; ms: the device time of one call by torch.profiler over reps
    calls, each of `kernels` (device-op name fragments, the kernel first)
    its mean per launch, summed, or wrapper_ms where the profiler saw one
    of them not at all (ms_by says which); kernel_ms: the first's;
    call_device_ms: every device op of one call (a fill included);
    plain_ms by CUDA events over plain_reps (default reps) calls; the
    bound of work, (bytes, f32 operations), at portbench/peaks.json's
    rates.  libraries, {name: one-call PyTorch version}: each one's ms by
    CUDA events, device ms and device kernels, the fastest as
    library_ms; without them library_ms is plain_ms where `row` names
    the library the plain version calls, else None.  `row`: the row's
    own keys (name, id, source, replaces, launches, max_abs_err,
    request, ...).  Returns (the row, device_ms' ops of fn)."""
    call_ms, ops = device_ms(fn, reps)
    each = named_ms(ops, kernels)
    wrapper_ms = cuda_ms(fn, reps)
    if all(v is not None for v, _ in each.values()):
        ms = sum(v for v, _ in each.values())
        ms_by = "profiler device time per call: " + ", ".join(
            f"{k} ({n} of {reps} seen)" for k, (_, n) in each.items())
    else:                       # no device trace: the whole call
        ms, ms_by = wrapper_ms, "CUDA events around the wrapper call"
    if libraries:
        libs = {}
        for name, call in libraries.items():
            lib_call_ms, lib_ops = device_ms(call, reps)
            libs[name] = dict(ms=cuda_ms(call, reps),
                              device_ms=lib_call_ms if lib_ops else None,
                              device_kernels={k[:96]: n for k, (_, n)
                                              in lib_ops.items()})
        fastest = min(libs, key=lambda n: libs[n]["ms"])
        row.update(libraries=libs, library=fastest,
                   library_ms=libs[fastest]["ms"])
    plain_ms = cuda_ms(plain, plain_reps or reps)
    row.setdefault("library", None)
    row.setdefault("library_ms", plain_ms if row["library"] else None)
    bound, bound_by = bound_s(*work)
    row.update(route="cuda", ms=ms, plain_ms=plain_ms, bound_ms=1e3 * bound,
               bound_by=bound_by, ms_by=ms_by, wrapper_ms=wrapper_ms,
               kernel_ms=each[kernels[0]][0],
               call_device_ms=call_ms if ops else None)
    print_probe(row, tag)
    return row, ops


def measure_probe(p, pid, launches, request, tag, reps):
    """One probe (kernel_probe.Probe) on its inputs: held against its
    plain version (p.agrees), then its kernel_row (the device ops of
    PROBE_SPECS, the bound of p.work(), its one-call PyTorch versions as
    the libraries).  Returns the kernels-line entry."""
    knames, src = PROBE_SPECS[p.name]
    ok, err = p.agrees(p.fn(*p.args), p.plain(*p.args))
    check(ok, f"{request}: {p.name} vs plain, max abs err {err}")
    return kernel_row(
        tag, lambda: p.fn(*p.args), lambda: p.plain(*p.args), knames,
        p.work(), reps=reps, libraries=p.library_calls(), name=p.name,
        id=pid, source=f"{CSRC}/probe.cu", replaces=src, launches=launches,
        max_abs_err=err, request=request, rows=p.rows)[0]


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

    entries = [measure_probe(p, pid, launches[p.name], "kernel_probe",
                             "phase 8", reps)
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
    seen = named_ms(device_ms(every_rung, 1)[1],
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
    print_probe(entries[-1], "phase 8")
    return entries


# ------------------------------------------ phases 9 and 10: training

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


def table_vs_sum64(g, sidx, vals, T, what, scale=1.0):
    """A table gradient g (an atomic f32 sum of the payloads vals into
    rows sidx of T rows, over `scale`) held within p3_sum_bound(n) x the
    sum of |payload| (over scale) of each (row, column) of the float64
    sum of the same payloads, for a row that takes n payloads.  Returns
    the numbers the kernels-line notes print."""
    def sum64(v):
        return torch.zeros((T, v.shape[1]), dtype=torch.float64,
                           device=v.device).index_add_(
            0, sidx.long(), v.double()).view(g.shape) / scale
    d = (g.double() - sum64(vals)).abs()
    mag = sum64(vals.abs())
    n = torch.bincount(sidx.long(), minlength=T).double()
    n = n[:, None].expand(T, vals.shape[1]).reshape(g.shape)
    over = d / (mag * p3_sum_bound(n)).clamp_min(1e-300)
    check(bool((over <= 1.0).all()), f"{what} beyond {P3_SUM_C} sqrt(n) "
          f"2^-24 x sum|payload| (max abs {float(d.max())}, "
          f"{float(over.max()):.3f} of the bound)")
    at = int(over.argmax())
    return {"": float(d.max()),
            "_err_over_sum_abs": float((d / mag.clamp_min(1e-300)).max()),
            "_share_of_bound": float(over.max()),
            "_terms_there": int(n.reshape(-1)[at]),
            "max_terms_a_row": int(n.max())}


HASH_GRID_KERNELS = ("hash_grid_encode", "hash_grid_grads")


def hash_grid_payloads(g, x, res, shape):
    """The hash-grid backward's table payloads as P3 would take them:
    (rows of the (L*T, F) view, int32; w_c * g, f32; L*T)."""
    from google_nerf_tpu_torch.ops.hash_grid import corners
    L, T, F = shape
    idx, w, _ = corners(x, tuple(res), T)
    rows = idx + torch.arange(L, device=x.device)[:, None, None] * T
    vals = w[..., None] * g.reshape(-1, L, F).permute(1, 0, 2)[:, None]
    return rows.reshape(-1).to(torch.int32), vals.reshape(-1, F), L * T


def hash_grid_entries(kept, launches, request, tag, reps=50):
    """The hash-grid kernels on the last training step's kept calls: the
    forward equal to its plain version bit for bit, the table gradient
    within p3_sum_bound of the float64 sum of its payloads; device ms by
    torch.profiler (the backward's memset and kernel), wrapper and plain
    ms by CUDA events; the bound of the bytes each must move once (x, the
    gather-dtype table and the features; or x, the features' gradient and
    the f32 table gradient).
    Returns the kernels-line entries."""
    from google_nerf_tpu_torch.ops.cuda import hash_grid as hg
    (tab, x, res), _ = kept["hash_grid_encode"].calls[0]
    (g, xb, _, resb, shape, tg, xg), _ = kept["hash_grid_grads"].calls[0]
    d = (hg.hash_grid_encode(tab, x, res)
         - hg.hash_grid_encode_plain(tab, x, res)).abs()
    err = float(d.max())
    check(err == 0.0, f"{request}: hash_grid_encode vs plain: max abs "
          f"{err}, expected bit for bit")
    dt, _ = hg.hash_grid_grads(g, xb, None, resb, shape)
    t_errs = table_vs_sum64(dt, *hash_grid_payloads(g, xb, resb, shape),
                            f"{request}: hash_grid_grads vs the float64 sum")
    n, (L, T, F) = x.shape[0], shape
    feats = n * L * F * 4
    runs = (("hash_grid_encode", lambda: hg.hash_grid_encode(tab, x, res),
             lambda: hg.hash_grid_encode_plain(tab, x, res),
             ("hash_grid_fwd_kernel",),
             n * 12 + tab.numel() * tab.element_size() + feats, err),
            ("hash_grid_grads",
             lambda: hg.hash_grid_grads(g, xb, None, resb, shape),
             lambda: hg.hash_grid_grads_plain(g, xb, None, resb, shape),
             ("hash_grid_bwd_kernel", "Memset (Device)"),
             n * 12 + feats + L * T * F * 4, t_errs[""]))
    return [kernel_row(
        tag, fn, plain, knames, (nbytes, 0), reps=reps, plain_reps=5,
        name=name, id="HG", source=f"{CSRC}/hash_grid.cu",
        replaces="none (XLA in google_nerf_tpu/models/encoders.py)",
        launches=launches[name], max_abs_err=e, request=request,
        rows=n * L * 8)[0] for name, fn, plain, knames, nbytes, e in runs]


def kernel_vs_plain_step(tsys, ph, state, scene, cfg, draws, *,
                         names=("gather_rows", "scatter_add_rows"),
                         table="packed_table", tag="phase 9"):
    """One step's loss and gradients with the encoder's kernels (`names`
    of module ph: P2 and P3, P3 alone, or the hash-grid kernels) and then
    with their plain versions, from one state, batch and set of draws:
    loss within rtol 1e-6, every gradient but the table's within rtol
    1e-6, the kernel step's table gradient within
    p3_sum_bound(n) x the sum of |payload| of its (row, column) of the
    float64 sum of its payloads, for a row that takes n payloads.
    Returns (errors, the recorded calls)."""
    batch = tsys.sample_batch(scene, cfg.batch_size,
                              img_idxs=draws["img_idxs"],
                              pix_idxs=draws["pix_idxs"])
    rec = {n: Recorder(getattr(ph, n)) for n in names}
    for n, r in rec.items():
        setattr(ph, n, r)
    try:
        lk, _, gk = tsys.loss_and_grads(state, scene, batch, cfg,
                                        draws=draws)
    finally:
        for n, r in rec.items():
            setattr(ph, n, r.fn)
    for n, r in rec.items():     # the plain version beside the kernel's
        setattr(ph, n, getattr(sys.modules[r.fn.__module__], n + "_plain"))
    try:
        lp, _, gp = tsys.loss_and_grads(state, scene, batch, cfg,
                                        draws=draws)
    finally:
        for n, r in rec.items():
            setattr(ph, n, r.fn)
    torch.cuda.synchronize()
    check(all(len(r.calls) == 1 for r in rec.values()),
          f"{tag}: the step did not make one call of each of {names}")
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    check(loss_err <= 1e-6, f"{tag}: kernel step loss {float(lk)} vs "
          f"plain {float(lp)}")
    errs = dict(loss_rel=loss_err)
    for k in gp:
        if k == table:
            continue
        ok = bool(((gk[k] - gp[k]).abs() <= 1e-6 * gp[k].abs()).all())
        errs[k] = float((gk[k] - gp[k]).abs().max())
        check(ok, f"{tag}: gradient {k} kernel vs plain beyond rtol 1e-6"
              f" (max abs {errs[k]})")
    if "hash_grid_grads" in rec:
        g, x, _, res, shape = rec["hash_grid_grads"].calls[0][0][:5]
        sidx, vals, T = hash_grid_payloads(g, x, res, shape)
    else:
        sidx, vals, T = rec["scatter_add_rows"].calls[0][0]
    t_errs = table_vs_sum64(gk[table], sidx, vals, T,
                            f"{tag}: table gradient kernel vs the float64 sum")
    errs.update({(k if k == "max_terms_a_row" else table + k): v
                 for k, v in t_errs.items()})
    errs[table + "_vs_plain"] = float((gk[table] - gp[table]).abs().max())
    return errs, rec


def phase9(seed, dev, steps=TRAIN_STEPS):
    """bench.py's training loop at full width from --seed: the textured
    scene, the grid cadence, fused steps; checks and timings as the
    module notes say.  Returns (state, cfg, summary, kernels-line
    entries)."""
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    from google_nerf_tpu_torch.ops import packed_hash as ph
    from google_nerf_tpu_torch.ops.cuda import probe
    from google_nerf_tpu_torch.train import system as tsys
    cfg = bench_torch.train_config()          # bench.py:92-117
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

    errs, rec = kernel_vs_plain_step(tsys, ph, state, scene, cfg,
                                     draws_of(gen, scene, cfg, dev))
    summary["kernel_vs_plain_step"] = errs
    print(f"phase 9: kernel step vs plain step {errs}", flush=True)
    return state, cfg, summary, probe_entries(probe, rec, launches, "train",
                                              "phase 9")


def trained_frame_errors(got, want, what, limit=1e-4, flip_limit=2e-3,
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
    check(d_op <= limit, f"{what}: opacity max {d_op} > {limit}")
    check(over <= flip_share * d_rgb.numel() and errs[1] <= flip_limit,
          f"{what}: rgb max {errs[1]}, {over} pixels past {limit} "
          f"(at most {flip_share * d_rgb.numel():.0f}, each within "
          f"{flip_limit})")
    for k in COUNTERS:
        check(int(got[k]) == int(want[k]), f"{what}: {k} "
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
    errs = trained_frame_errors(frame, plain, "trained wl256")
    p = float(psnr(frame["rgb"], gt))
    times = frame_ms(serve, 3)
    out = dict(bake_s=bake_s, n_blocks=int(baked["n_blocks"]),
               counters=counters_of(frame), launches=launches, psnr=p,
               frame_ms=times, plain_frame_err=errs,
               mean_opacity=float(frame["opacity"].mean()))
    print(f"phase 10: trained wl256: {out}", flush=True)
    check(p >= 40.0, f"phase 10: trained wl256 psnr {p} < 40 dB")
    return out


# ------------------------------- phase 11: bench.py's serving stages

def stage_kernel(rbm, bf, name, request, frame, names, launches):
    """A stage's tile kernel on one more frame of the stage: its calls
    recorded, the frame against the frame through the plain versions of
    `names` at the trained tolerance, and its kernels-line entry."""
    fr, calls, _ = run_request(rbm, bf, name, frame)
    errs = trained_frame_errors(fr, plain_frame(rbm, bf, names, frame),
                                request)
    return errs, measure(bf, name, calls, request, launches, reps=3,
                         trained=True)


def oneshot_p2(ph, probe, frame, launches):
    """P2 on the one-shot frame: the largest encoder gather of one more
    frame (a full drain trip), as probe_entries measures a served gather.
    Returns the kernels-line entry."""
    _, kept = with_kept(ph, {"gather_rows": dict(keep="largest")}, frame)
    e, = probe_entries(probe, kept, {"gather_rows_bf16": launches},
                       "oneshot", "phase 11", reps=20)
    e["gathers_per_frame"] = kept["gather_rows"].n
    return e


def lpips_scopes(pred, gt, dev, reps=3):
    """LPIPS-vgg of two 800x800 frames ((H*W, 3) in [0, 1]) on random
    weights of the converter's shapes, under the scope eval/metrics.py
    had (cudnn.flags(allow_tf32=False), which also turns cuDNN off) and
    under the one it has (exact_f32: cuDNN on, TF32 off): the two
    distances (within rtol 1e-4: both f32) and each one's ms by CUDA
    events, in one call."""
    from google_nerf_tpu_torch.eval import metrics
    gen = torch.Generator().manual_seed(0)
    w, cin, li = {}, 3, 0
    for b, widths in enumerate(metrics._VGG_BLOCKS):
        for width in widths:
            w[f"conv{li}_w"] = (torch.randn((width, cin, 3, 3), generator=gen)
                                * (2.0 / (9 * cin)) ** 0.5).to(dev)
            w[f"conv{li}_b"] = torch.zeros(width, device=dev)
            cin, li = width, li + 1
        w[f"lin{b}_w"] = (torch.rand((1, cin, 1, 1), generator=gen)
                          / cin).to(dev)
    x, y = (t.reshape(800, 800, 3).permute(2, 0, 1)[None] * 2 - 1
            for t in (pred, gt))

    def cudnn_off():
        with torch.backends.cudnn.flags(allow_tf32=False):
            fx = metrics._vgg_features(w, x)
            fy = metrics._vgg_features(w, y)
        return metrics._lpips_heads(w, fx, fy)

    def exact():
        return metrics._lpips_impl(w, x, y)

    d_off, d_on = float(cudnn_off()), float(exact())
    check(abs(d_on - d_off) <= 1e-4 * abs(d_off),
          f"phase 11: LPIPS {d_on} under exact_f32, {d_off} with cuDNN off")
    return dict(lpips=d_on, lpips_cudnn_off=d_off,
                ms_cudnn_off=cuda_ms(cudnn_off, reps),
                ms_exact_f32=cuda_ms(exact, reps))


def phase11(state, tcfg, dev):
    """bench.py's serving stages on phase 9's trained state, in bench.py's
    order, through bench_torch's stage functions at its settings (the
    800x800 test-split pose, ms_render 512).  Each stage runs with the K1,
    K2 and P2 counters at 0 just before it (read just after); then its
    checks: mxu (K2 on the trained 512^3 bake) PSNR >= 40 dB, 0 pairs
    undrained, the frame against its plain frame at phase 10's trained
    tolerance; oneshot PSNR >= 40 dB, P2 launched, mxu_vs_oneshot_mae <=
    5e-3; baked_oneshot baked_vs_live_mae <= 3e-3; brick brick_vs_mxu_mae
    <= 5e-3; mixed (K1 on the padded mixed pool) PSNR >= 40 dB, the frame
    against its plain frame at the trained tolerance.  The MAE bounds and
    PSNR anchors are BENCH_r05's (TPU-run quality figures): 0.0012,
    0.0008, 0.0022; 43.19, 43.92, 42.93 dB.  Returns (per-stage summary,
    bench keys, kernels-line entries)."""
    import google_nerf_tpu_torch.models.render_brick_mxu as rbm
    from google_nerf_tpu_torch.eval.metrics import psnr
    from google_nerf_tpu_torch.ops import packed_hash as ph
    from google_nerf_tpu_torch.ops.cuda import brick_field as bf
    from google_nerf_tpu_torch.ops.cuda import probe
    model = tcfg.model
    view = bench_torch.serving_view(dev)
    shared, keys, summary, entries = {}, {}, {}, []
    for name, fn in bench_torch.STAGES:
        for k in KERNELS:
            getattr(bf, k).launches = 0
        probe.gather_rows.launches = {"float32": 0, "bfloat16": 0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kv = bench_torch.run_stage(name, fn, state, model, view, shared, dev)
        torch.cuda.synchronize()
        launches = {k: getattr(bf, k).launches for k in KERNELS}
        launches["gather_rows_bf16"] = probe.gather_rows.launches["bfloat16"]
        check(not [k for k in kv if k.endswith(("_skipped", "_error"))],
              f"phase 11: stage {name} reported {kv}")
        keys.update(kv)
        info = dict(keys=kv, launches=launches,
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out = shared.get("out", {}).get(name)
        if out is not None:
            check(tuple(out["rgb"].shape) == (800 * 800, 3)
                  and bool(torch.isfinite(out["rgb"]).all()),
                  f"phase 11: {name} frame shape or values")
            mx = shared["out"].get("mxu")
            info.update(warm_ms=shared["warm_ms"][name],
                        psnr=float(psnr(out["rgb"], view.gt)),
                        mae_vs_mxu=None if mx is None else float(
                            (out["rgb"] - mx["rgb"]).abs().mean()),
                        counters={k: int(out[k]) for k in (
                            COUNTERS + ("pairs_dropped", "pairs_total",
                                        "drain_trips", "alive_after_main"))
                            if k in out})
        if name == "mxu":
            check(info["psnr"] >= 40.0, f"trained mxu psnr {info['psnr']}")
            check(info["counters"]["pairs_undrained"] == 0,
                  "trained mxu left pairs undrained")
            check(launches["brick_field_tiles_tp"] > 0,
                  "K2 not launched on the trained mxu stage")
            info["plain_frame_err"], e = stage_kernel(
                rbm, bf, "brick_field_tiles_tp", "trained mxu",
                shared["frames"]["mxu"], ("brick_field_tiles_tp",),
                launches["brick_field_tiles_tp"])
            entries.append(e)
        elif name == "brick":
            check(info["mae_vs_mxu"] <= 5e-3,
                  f"brick_vs_mxu_mae {info['mae_vs_mxu']} > 5e-3")
        elif name == "oneshot":
            check(info["psnr"] >= 40.0, f"oneshot psnr {info['psnr']}")
            check(info["mae_vs_mxu"] <= 5e-3,
                  f"mxu_vs_oneshot_mae {info['mae_vs_mxu']} > 5e-3")
            check(launches["gather_rows_bf16"] > 0,
                  "P2 not launched on the oneshot stage")
            entries.append(oneshot_p2(ph, probe, shared["frames"]["oneshot"],
                                      launches["gather_rows_bf16"]))
        elif name == "baked_oneshot":
            info["mae_vs_live"] = float((out["rgb"] - shared["out"][
                "oneshot"]["rgb"]).abs().mean())
            check(info["mae_vs_live"] <= 3e-3,
                  f"baked_vs_live_mae {info['mae_vs_live']} > 3e-3")
        elif name == "mixed":
            mixed = shared["mixed"]
            info["n_blocks"] = int(mixed["baked"]["n_blocks"])
            info["stats"] = mixed["stats"]
            check(info["n_blocks"] % bench_torch.SETTINGS["pad_mult"] == 0,
                  "mixed pool not padded")
            check(info["psnr"] >= 40.0, f"mixed psnr {info['psnr']}")
            check(launches["brick_field_tiles_wl"] > 0,
                  "K1 not launched on the mixed stage")
            info["plain_frame_err"], e = stage_kernel(
                rbm, bf, "brick_field_tiles_wl", "trained mixed",
                shared["frames"]["mixed"], ("brick_field_tiles_wl",
                                            "brick_field_tiles_tp"),
                launches["brick_field_tiles_wl"])
            entries.append(e)
        summary[name] = info
        print(f"phase 11: {name}: {info}", flush=True)
    summary["lpips"] = lpips_scopes(shared["out"]["mxu"]["rgb"], view.gt,
                                    dev)
    print(f"phase 11: LPIPS of the mxu frame (F4): {summary['lpips']}",
          flush=True)
    del shared
    torch.cuda.empty_cache()
    return summary, keys, entries


# ---------------------------------- phase 12: the CLIs, train -> serve

CLI_STEPS = 1024            # opt.py's default is 30 epochs x 1000 steps
# phase 13's runs, cut to half of CLI_STEPS to keep the script inside
# its time limit as phases 17-18 joined (validated at 36.99-38.25
# dB); phase 14's runs but hash's and phase 20's take it too
DATA_STEPS = 512
CLI_SCENE = ["--root_dir", "x", "--dataset_name", "synthetic",
             "--synthetic_style", "textured", "--downsample", "4"]
VIEW_800 = ["--downsample", "12.5"]          # the test views at 800x800
VIEWS_800 = 10     # test views of the 800^2 runs (the synthetic split: 50)
# every tile of a chunk drainable, the drain lists unfiltered
BRICK_EXACT = ["--brick_mxu_drain", "1024", "--brick_mxu_drain_xc", "0"]


class synthetic_views:
    """While the `with` block runs, the CLIs' synthetic dataset makes `n`
    views a split (its default is 50): a cut of depth."""

    def __init__(self, n):
        import functools

        from google_nerf_tpu_torch.data import dataset_dict
        self.table, self.cls = dataset_dict, dataset_dict["synthetic"]
        self.cut = functools.partial(self.cls, n_images=n)

    def __enter__(self):
        self.table["synthetic"] = self.cut

    def __exit__(self, *exc):
        self.table["synthetic"] = self.cls


def reset_cli_counters(bf, probe):
    from google_nerf_tpu_torch.ops.cuda import hash_grid
    for k in KERNELS:
        getattr(bf, k).launches = 0
    probe.gather_rows.launches = {"float32": 0, "bfloat16": 0}
    probe.scatter_add_rows.launches = 0
    for k in HASH_GRID_KERNELS:
        getattr(hash_grid, k).launches = 0


def cli_counters(bf, probe):
    from google_nerf_tpu_torch.ops.cuda import hash_grid
    out = {k: getattr(bf, k).launches for k in KERNELS}
    out["gather_rows_bf16"] = probe.gather_rows.launches["bfloat16"]
    out["scatter_add_rows"] = probe.scatter_add_rows.launches
    out.update({k: getattr(hash_grid, k).launches for k in HASH_GRID_KERNELS})
    return out


def with_kept(mod, names, run):
    """run() with mod's wrappers `names` ({name: Recorder keywords})
    recorded; returns (run's result, {name: its Recorder})."""
    keep = {n: Recorder(getattr(mod, n), **kw) for n, kw in names.items()}
    for n, k in keep.items():
        setattr(mod, n, k)
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for n, k in keep.items():
            setattr(mod, n, k.fn)
    return out, keep


def kept_training(tsys, ph, run, names=("gather_rows", "scatter_add_rows")):
    """run() with the P2/P3 calls (`names` of module ph) made inside
    fused_train_step recorded (the last of each); returns (run's result,
    their Recorders)."""
    in_step = [False]
    step_fn = tsys.fused_train_step

    def gated_step(*a, **k):
        in_step[0] = True
        try:
            return step_fn(*a, **k)
        finally:
            in_step[0] = False

    gate = dict(keep="last", gate=lambda: in_step[0])
    tsys.fused_train_step = gated_step
    try:
        return with_kept(ph, {n: gate for n in names}, run)
    finally:
        tsys.fused_train_step = step_fn


def probe_entries(probe, kept, launches, request, tag, reps=50):
    """P2 on the encoder gather kept (the last training step's, or a
    renderer's largest) and P3 on the table gradient kept, each where
    `kept` (Recorders of the encoder's wrappers) holds it, measured as
    phase 8 measures the probes and printed under `tag`."""
    from google_nerf_tpu_torch.tools.kernel_probe import Probe
    out = []
    if "gather_rows" in kept:
        (tab, idx), _ = kept["gather_rows"].calls[0]
        n = idx.numel()
        out.append(measure_probe(Probe(
            request, "gather_rows_bf16",
            f"the encoder's row gather, {n} x {tab.shape[1]} bf16 from "
            f"{tab.shape[0]} rows", probe.gather_rows,
            probe.gather_rows_plain, (tab, idx), n), "P2",
            launches["gather_rows_bf16"], request, tag, reps))
    if "scatter_add_rows" in kept:
        (sidx, vals, T), _ = kept["scatter_add_rows"].calls[0]
        n = sidx.numel()
        out.append(measure_probe(Probe(
            request, "scatter_add_rows",
            f"the table gradient, {n} x {vals.shape[1]} f32 onto {T} rows",
            probe.scatter_add_rows, probe.scatter_add_rows_plain,
            (sidx, vals, T), n, scatter=True), "P3",
            launches["scatter_add_rows"], request, tag, reps))
    return out


VALIDATE_PSNR = 25.0        # dB: a CLI run's validate floor
# the packed encoder: the module that calls its kernels, the wrappers it
# calls, its table's param key (ENCODER_RUNS gives the others)
PACKED = ("ops.packed_hash", ("gather_rows", "scatter_add_rows"),
          "packed_table")
COUNTER = {"gather_rows": "gather_rows_bf16"}   # a wrapper's counter key
MARCHES = ("march_rays_train_block", "march_rays_train_seg")


@dataclass(frozen=True)
class Serve:
    """One serving run of a CLI leg's checkpoint: test_torch.run on the
    leg's argv and `flags` (train_torch.main with --val_only among them);
    the VIEW_800 flags make the synthetic split VIEWS_800 views.
    launched: the counters that must be past 0; gap: the most its PSNR
    may lie from validate's, in dB (None: not held); request: the
    kernels-line request of its kept calls (K2's first 160 for
    brick_mxu, else P2's largest gather); marches: count the one-shot
    renderer's marcher calls (under --march block the block marcher must
    run and the segment marcher not)."""
    label: str
    flags: tuple = ()
    launched: tuple = ("gather_rows_bf16",)
    gap: float | None = None
    request: str | None = None
    marches: bool = False


def cli_leg(tag, label, argv, *, encoder=PACKED, request=None,
            early_at=None, psnr_ok=None, depth=None, serve=(), slim=True,
            step=None):
    """A CLI run as a user makes it, in the working directory: training
    (train_torch.main, or train_scannet_torch.run for a scannet argv)
    with every kernel counter at 0 just before (read just after) and the
    last calls of the encoder's wrappers inside the train steps kept
    (`encoder`: its module under google_nerf_tpu_torch, those wrappers,
    its table's param key); then each `serve` run of the slim checkpoint
    (the full one with slim False), the counters at 0 before each; then,
    with step = (seed, split or None), one step from the trained state
    on that split's draws with the encoder's kernels against one with
    their plain versions (kernel_vs_plain_step: phase 9's bounds).

    Checks: both checkpoints written; each wrapper of the encoder
    launched in training; unless --no_save_test, the logged losses, one
    every 100 steps, finite; validate's PSNR >= VALIDATE_PSNR, or
    psnr_ok(it, the train psnr at step early_at); with --depth_dir, a
    logged depth term, every one finite and positive; each serving run
    as Serve says.  With `request`, the encoder's kernels on the last
    train step's calls join the kernels line (the hash-grid kernels, or
    P2/P3).  depth = (the test views' ray depth in metres, its mask):
    their depth MAE from the trained state (printed, not checked).
    Returns (the training's summary, {serve label: its summary},
    kernels-line entries)."""
    import importlib
    import os

    import google_nerf_tpu_torch.models.render_brick_mxu as rbm
    import google_nerf_tpu_torch.models.render_test_oneshot as ros
    import test_torch
    import train_scannet_torch
    import train_torch
    from google_nerf_tpu_torch.opt import get_opts
    from google_nerf_tpu_torch.ops import packed_hash as ph
    from google_nerf_tpu_torch.ops.cuda import brick_field as bf
    from google_nerf_tpu_torch.ops.cuda import probe
    from google_nerf_tpu_torch.train import system as tsys
    dev = torch.device("cuda")
    hp = get_opts(argv)
    steps = hp.num_epochs * hp.steps_per_epoch
    modname, names, table = encoder
    mod = (importlib.import_module(f"google_nerf_tpu_torch.{modname}")
           if modname else None)
    ckpt = f"ckpts/{hp.dataset_name}/{hp.exp_name}/epoch={hp.num_epochs - 1}"

    def run():
        if hp.dataset_name == "scannet":
            return train_scannet_torch.run(argv)
        return train_torch.main(get_opts(argv))

    reset_cli_counters(bf, probe)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    (logs, early), kept = kept_training(
        tsys, mod, lambda: steps_metrics(tsys, early_at, run), names)
    launches = cli_counters(bf, probe)
    info = dict(logs, launches=launches, wall_s=time.time() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for d in (ckpt, ckpt + "_slim"):
        check(os.path.isfile(os.path.join(d, "state.pt")),
              f"{tag}: no checkpoint {d}")
    for n in names:
        k = COUNTER.get(n, n)
        check(launches[k] > 0, f"{tag}: {k} not launched by the {label} "
              "training")
    if not hp.no_save_test:     # the run logs under its results
        recs = [json.loads(line) for line in open(
            f"results/{hp.dataset_name}/{hp.exp_name}/logs/scalars.jsonl")]
        losses = [r["loss"] for r in recs if "loss" in r]
        check(len(losses) == steps // 100 and all(
            math.isfinite(v) for v in losses),
            f"{tag}: {label} logged losses {losses}")
        dterm = [r["depth_loss"] for r in recs if "depth_loss" in r]
        if hp.depth_dir:
            check(dterm and all(math.isfinite(v) and v > 0 for v in dterm),
                  f"{tag}: {label} logged depth terms {dterm}")
        info.update(records=recs, logged_loss=losses, depth_loss=dterm)
    if early_at:
        info["train_psnr_early"] = early
    ok = (logs["psnr"] >= VALIDATE_PSNR if psnr_ok is None
          else psnr_ok(logs["psnr"], early))
    check(ok, f"{tag}: {label} validate psnr {logs['psnr']} (the floor "
          f"{VALIDATE_PSNR} dB, or its rule on the train psnr {early} at "
          f"step {early_at})")
    print(f"{tag}: {label}: {steps} steps in {info['wall_s']:.1f} s (with "
          f"setup and validate); {logs.get('ms_per_step')} ms/step net of "
          f"warm-up, {logs.get('rays_per_sec')} rays/s; "
          + (f"train psnr at step {early_at} {early:.3f}; " if early_at
             else "")
          + f"validate psnr {logs['psnr']:.3f}, ssim {logs['ssim']:.4f}; "
          f"peak {info['peak_gib']:.2f} GiB; launches {launches}",
          flush=True)
    entries = []
    if request:
        entries += (hash_grid_entries(kept, launches, request, tag)
                    if "hash_grid_encode" in kept else
                    probe_entries(probe, kept, launches, request, tag))
    del kept
    if depth is not None:
        info["depth_mae_m"] = test_view_depth_mae(argv, ckpt, *depth)
        print(f"{tag}: {label}: test-view depth MAE {info['depth_mae_m']:.4f}"
              " m (printed, not checked)", flush=True)

    served = {}
    for s in serve:
        if s.request and "brick_mxu" in s.flags:
            keep = rbm, {"brick_field_tiles_tp": dict(keep="first", first=160)}
        elif s.request:
            keep = ph, {"gather_rows": dict(keep="largest")}
        elif s.marches:
            keep = ros, {n: dict(keep="first", first=0) for n in MARCHES}
        else:
            keep = None, {}
        cli = train_torch.main if "--val_only" in s.flags else test_torch.run
        opts = get_opts(argv + list(s.flags) + [
            "--ckpt_path", ckpt + ("_slim" if slim else "")])
        views = (synthetic_views(VIEWS_800) if VIEW_800[1] in s.flags
                 else contextlib.nullcontext())
        reset_cli_counters(bf, probe)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with views:
            out, kept = with_kept(*keep, lambda: cli(opts))
        sl = cli_counters(bf, probe)
        got = dict(out, launches=sl, wall_s=time.time() - t0,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        check(math.isfinite(out["psnr"]), f"{tag}: {s.label} psnr "
              f"{out['psnr']}")
        for k in s.launched:
            check(sl[k] > 0, f"{tag}: {k} not launched by {s.label}")
        if s.gap is not None:
            got["gap_db"] = abs(out["psnr"] - logs["psnr"])
            check(got["gap_db"] <= s.gap, f"{tag}: {s.label} psnr "
                  f"{out['psnr']}, {got['gap_db']} dB from validate's "
                  f"(at most {s.gap})")
        if s.marches:
            got["marches"] = m = {n: r.n for n, r in kept.items()}
            if hp.march == "block":
                check(m["march_rays_train_block"] > 0
                      and m["march_rays_train_seg"] == 0,
                      f"{tag}: --march block served with {m}")
        print(f"{tag}: {s.label} ({' '.join(s.flags) or 'the defaults'}): "
              f"psnr {out['psnr']:.3f}, fps {out.get('fps')}; frame 0 "
              f"{out.get('frame0')}; launches {sl}; {got['wall_s']:.1f} s",
              flush=True)
        if "brick_field_tiles_tp" in kept:
            entries.append(measure(
                bf, "brick_field_tiles_tp", kept["brick_field_tiles_tp"].calls,
                s.request, sl["brick_field_tiles_tp"], reps=3, trained=True))
        elif s.request:
            entries += probe_entries(probe, kept, sl, s.request, tag, reps=20)
        del kept
        served[s.label] = got

    if step is not None:
        seed, split = step
        state, scene, cfg = restored_state(argv, ckpt, dev, split)
        draws = draws_of(torch.Generator(device=dev).manual_seed(seed), scene,
                         cfg, dev)
        info["kernel_vs_plain_step"], _ = kernel_vs_plain_step(
            tsys, mod, state, scene, cfg, draws, names=names, table=table,
            tag=f"{tag} {label}")
        print(f"{tag}: {label} kernel step vs plain step "
              f"{info['kernel_vs_plain_step']}", flush=True)
        del state, scene
    return info, served, entries


def train_keys(info):
    """The keys phases 17, 20 and 21 report of a CLI leg's training."""
    return dict(train_wall_s=info["wall_s"],
                ms_per_step=info.get("ms_per_step"),
                rays_per_sec=info.get("rays_per_sec"), psnr=info["psnr"],
                ssim=info["ssim"], launches=info["launches"],
                peak_gib=info["peak_gib"],
                kernel_vs_plain_step=info["kernel_vs_plain_step"])


def phase12(seed, steps=CLI_STEPS):
    """The CLIs as a user runs them, in a temporary directory:
    train_torch.main at opt.py's defaults (f32, batch 8192, the packed
    encoder of 8 levels x 2^16, grid 128, max_samples 1024, k_samples
    256, the seg march with sup 4 and n_keep_sup 24, backfill, budget 16
    x batch) on the textured scene at 256^2 (--downsample 4: 50 train
    and 50 test views), cut only in depth (1 epoch of `steps`); then
    --val_only on its full checkpoint; then test_torch.run on it with
    the renderers oneshot and fast, oneshot on fast's 1024-sample
    lattice, brick_mxu (512^3 bake, tp) at test.py's defaults; then, on
    VIEWS_800 test views at 800^2, oneshot over the 512^3 bake (--bake)
    and brick_mxu with every tile drainable (BRICK_EXACT); one cli_leg.
    Checks, beyond the leg's (the validate floor, P2 and P3 launched in
    training, the logged losses, both checkpoints): the --val_only logs
    within 1e-4 dB of validate's, P2 launched there; P2 launched by
    every run of the live field, K2 by every brick_mxu run; fast's PSNR
    within 0.5 dB of oneshot's on the same lattice; the 800^2 brick_mxu
    frame 0 with no pair undrained and its PSNR within 1.5 dB of
    oneshot's over the same bake (the other gaps printed).  P2/P3 on the
    training steps' last calls, P2 on the largest gather of the default
    oneshot and of fast, and K2 on the 800^2 brick_mxu run's first 160
    calls join the kernels line (requests "cli train", "cli oneshot",
    "cli fast", "cli brick_mxu").  Returns (summary, kernels-line
    entries)."""
    import os
    import tempfile
    argv = CLI_SCENE + ["--num_epochs", "1", "--steps_per_epoch", str(steps),
                        "--seed", str(seed), "--exp_name", "cli"]
    cut = (f"depth cut: 1 epoch of {steps} steps (opt.py: 30 x 1000), "
           f"{VIEWS_800} test views at 800^2 (the split: 50); widths at "
           "opt.py's defaults")
    print(f"phase 12: {cut}", flush=True)
    summary = dict(cut=cut, steps=steps)
    k2 = ("brick_field_tiles_tp",)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # fast marches the 1024-sample lattice, oneshot test.py's 512
            # by default: fast is held to oneshot on its own lattice.  At
            # 256^2 an 8x8 tile spans ~10x the solid angle of an 800^2
            # frame's and brick_mxu's tile lists at test.py's defaults
            # overflow their drain (pairs undrained, printed); at 800^2
            # with every tile drainable (BRICK_EXACT) it leaves none, and
            # is held to oneshot over the same bake (the 512^3 bake, not
            # the renderer, sets its distance from the live field).
            train, served, entries = cli_leg(
                "phase 12", "cli", argv, request="cli train", slim=False,
                serve=(Serve("val_only", ("--val_only", "--no_save_test"),
                             gap=1e-4),
                       Serve("oneshot", ("--renderer", "oneshot"),
                             request="cli oneshot"),
                       Serve("fast", ("--renderer", "fast"),
                             request="cli fast"),
                       Serve("oneshot_1024", ("--renderer", "oneshot",
                                              "--render_max_samples",
                                              "1024")),
                       Serve("brick_mxu_256", ("--renderer", "brick_mxu"),
                             launched=k2),
                       Serve("oneshot_baked_800", ("--renderer", "oneshot",
                                                   *VIEW_800, "--bake"),
                             launched=()),
                       Serve("brick_mxu_800", ("--renderer", "brick_mxu",
                                               *VIEW_800, *BRICK_EXACT),
                             launched=k2, request="cli brick_mxu")))
            val = served.pop("val_only")
            summary.update(train=train, val_only=dict(val, diff={
                k: abs(val[k] - train[k]) for k in ("psnr", "ssim")}))
            gap = {k: abs(served[a]["psnr"] - served[b]["psnr"])
                   for k, a, b in (
                       ("fast_vs_oneshot", "fast", "oneshot"),
                       ("fast_vs_oneshot_1024", "fast", "oneshot_1024"),
                       ("brick_mxu_vs_oneshot_256", "brick_mxu_256",
                        "oneshot"),
                       ("brick_mxu_vs_baked_oneshot_800", "brick_mxu_800",
                        "oneshot_baked_800"))}
            print(f"phase 12: psnr gaps {gap}", flush=True)
            check(gap["fast_vs_oneshot_1024"] <= 0.5,
                  f"phase 12: fast psnr {gap['fast_vs_oneshot_1024']} dB "
                  "from oneshot's on its lattice")
            check(served["brick_mxu_800"]["frame0"]["pairs_undrained"] == 0,
                  "phase 12: brick_mxu at 800^2 left pairs undrained")
            check(gap["brick_mxu_vs_baked_oneshot_800"] <= 1.5,
                  "phase 12: brick_mxu psnr "
                  f"{gap['brick_mxu_vs_baked_oneshot_800']} dB from oneshot's "
                  "over the same bake at 800^2")
            summary["psnr_gaps"] = gap
            summary["serve"] = served
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    return summary, entries


# ------------------------------ phase 13: datasets on disk, train -> serve

NSVF_VIEWS = (24, 4)         # 800^2 train, test views (Synthetic-NeRF: 100, 200)
SCANNET_FRAMES = (24, 4)     # train, test frames (a ScanNet scan: hundreds)
SCANNET_K = ((577.87, 0.0, 319.5), (0.0, 577.87, 239.5), (0.0, 0.0, 1.0))
SCANNET_COLOR_WH = (1296, 968)
SCANNET_SHIFT = (2.0, 1.5, 1.0)   # metres: the scan's AABB centre
SCANNET_SCALE = 2.0               # metres: the loader's scale (AABB/2 x 1.05)
JPEG_QUALITY = 95
JPEG_MIN_PSNR = 40.0              # tests/test_torch_image.py's round trip


def _homog(c2w):
    return np.concatenate([c2w, [[0.0, 0.0, 0.0, 1.0]]], 0)


def write_nsvf_scene(root, seed, dev):
    """A Synthetic_NeRF-layout scene of the textured procedural scene:
    800x800 RGBA PNGs (straight colour, alpha = the integrator's opacity)
    of 0_* train and 2_* test views, pose/*.txt, intrinsics.txt (focal
    800) and bbox.txt (the loader's AABB x 1.05 is [-0.5, 0.5]^3, so
    the files' poses are the scene's).  Returns the decode checks."""
    import os

    from google_nerf_tpu_torch.data.base import directions_of
    from google_nerf_tpu_torch.data.synthetic import (_fibonacci_poses,
                                                      render_views)
    from google_nerf_tpu_torch.utils.image import read_image, write_png
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "pose"))
    r = 0.5 / 1.05
    with open(os.path.join(root, "bbox.txt"), "w") as f:
        f.write(f"{-r} {-r} {-r} {r} {r} {r} 0.01\n")
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write("800.0 400.0 400.0 0.\n0. 0. 0.\n0.\n1.\n800 800\n")
    K = np.float32([[800, 0, 400], [0, 800, 400], [0, 0, 1]])
    dirs = directions_of(800, 800, K)
    worst, decode_s, n = 0, 0.0, 0
    for prefix, count, s in (("0_", NSVF_VIEWS[0], seed),
                             ("2_", NSVF_VIEWS[1], seed + 1000)):
        poses = _fibonacci_poses(count, 1.2, s)
        rgba = render_views(dirs, poses, style="textured", device=dev)
        for i in range(count):
            a = np.clip(rgba[i, :, 3], 0.0, 1.0)
            rgb = np.where(a[:, None] > 1 / 510, rgba[i, :, :3]
                           / np.maximum(a[:, None], 1e-6), 0.0)
            img = np.concatenate([rgb, a[:, None]], -1).reshape(800, 800, 4)
            img = (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
            path = os.path.join(root, "rgb", f"{prefix}{i:04d}.png")
            write_png(path, img)
            np.savetxt(os.path.join(root, "pose", f"{prefix}{i:04d}.txt"),
                       _homog(poses[i]))
            t0 = time.time()
            back = read_image(path)
            decode_s += time.time() - t0
            n += 1
            worst = max(worst, int(np.abs(back.astype(int) - img).max()))
    return dict(png_max_abs_err=worst, png_decode_s=decode_s / n, views=n)


def write_scannet_scene(root, seed, dev):
    """A ScanNet-layout scene of the textured procedural scene in a
    metric frame (the unit cube scaled by 2 x SCANNET_SCALE m and moved
    to SCANNET_SHIFT): 1296x968 JPEGs (the port's encoder, quality 95)
    with K scaled from the 640x480 intrinsic_depth.txt, pose/*.txt,
    <raw>/<scene>/<scene>_vh_clean_2.ply whose AABB x 1.05 maps the
    cube onto [-0.5, 0.5]^3, test_step_10/{train,test}.txt, and depth
    priors: 16-bit PNGs in mm of the integrator's expected z-depth at
    640x480 (0 where its opacity is under 0.5).  Returns (scene dir, raw
    root, priors dir, the decode checks, the test views' analytic ray
    depth (N, 640*480) in metres and its mask)."""
    import os

    from google_nerf_tpu_torch.data.base import directions_of
    from google_nerf_tpu_torch.data.ply import save_point_cloud
    from google_nerf_tpu_torch.data.synthetic import (_fibonacci_poses,
                                                      render_views)
    from google_nerf_tpu_torch.utils.image import (read_image, write_jpeg,
                                                   write_png)
    name = "scene0000_00"
    scene = os.path.join(root, "scans_processed", name)
    raw = os.path.join(root, "scans")
    priors = os.path.join(root, "priors", name)
    for d in (os.path.join(scene, "rgb"), os.path.join(scene, "pose"),
              os.path.join(scene, "test_step_10"), os.path.join(raw, name),
              priors):
        os.makedirs(d)
    shift = np.asarray(SCANNET_SHIFT)
    half = SCANNET_SCALE / 1.05
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * half + shift
    save_point_cloud(os.path.join(raw, name, f"{name}_vh_clean_2.ply"),
                     corners.astype(np.float32))
    Kd = np.float32(SCANNET_K)
    np.savetxt(os.path.join(scene, "intrinsic_depth.txt"),
               _homog(np.concatenate([Kd, np.zeros((3, 1))], 1)))
    cw, ch = SCANNET_COLOR_WH
    Kc = Kd.copy()
    Kc[0] *= cw / 640
    Kc[1] *= ch / 480
    n_train, n_test = SCANNET_FRAMES
    n = n_train + n_test
    poses = _fibonacci_poses(n, 1.2, seed)
    test_ids = [i for i in range(n) if i % 5 == 4][:n_test]
    with open(os.path.join(scene, "test_step_10", "train.txt"), "w") as f:
        f.write("".join(f"{i}\n" for i in range(n) if i not in test_ids))
    with open(os.path.join(scene, "test_step_10", "test.txt"), "w") as f:
        f.write("".join(f"{i}\n" for i in test_ids))
    dirs_c = directions_of(ch, cw, Kc)
    dirs_d = directions_of(480, 640, Kd)
    inv_norm = 1.0 / np.linalg.norm(dirs_d, axis=-1)        # z / ray
    worst_psnr, decode_s, depth_err, png_err = np.inf, 0.0, 0.0, 0
    test_depth, test_mask = [], []
    for i in range(n):
        c2w = poses[i].astype(np.float64).copy()
        c2w[:, 3] = c2w[:, 3] * 2 * SCANNET_SCALE + shift
        np.savetxt(os.path.join(scene, "pose", f"{i}.txt"), _homog(c2w))
        rgba = render_views(dirs_c, poses[i:i + 1], style="textured",
                            device=dev)[0]
        rgb = np.clip(rgba[:, :3] + (1 - rgba[:, 3:4]), 0, 1)
        img = (rgb.reshape(ch, cw, 3) * 255 + 0.5).astype(np.uint8)
        path = os.path.join(scene, "rgb", f"{i}.jpg")
        write_jpeg(path, img, quality=JPEG_QUALITY)
        t0 = time.time()
        back = read_image(path)
        decode_s += time.time() - t0
        mse = np.mean((back.astype(np.float64) - img) ** 2)
        worst_psnr = min(worst_psnr, 10 * np.log10(255.0 ** 2 / mse))
        dep = render_views(dirs_d, poses[i:i + 1], style="textured",
                           with_depth=True, device=dev)[0]
        mask = dep[:, 3] > 0.5
        ray_m = np.where(mask, dep[:, 4] / np.maximum(dep[:, 3], 1e-6),
                         0.0) * 2 * SCANNET_SCALE
        mm = ray_m * inv_norm * 1000.0
        path = os.path.join(priors, f"{i}.png")
        mm16 = np.round(mm).astype(np.uint16).reshape(480, 640)
        write_png(path, mm16)
        back = read_image(path)
        png_err = max(png_err, int(np.abs(back.astype(np.int64)
                                          - mm16).max()))
        depth_err = max(depth_err, float(np.abs(
            back.reshape(-1).astype(np.float64) - mm).max()))
        if i in test_ids:
            test_depth.append(ray_m)
            test_mask.append(mask)
    checks = dict(jpeg_min_psnr=worst_psnr, jpeg_decode_s=decode_s / n,
                  prior_png_max_abs_err=png_err, prior_max_err_mm=depth_err,
                  frames=n)
    return scene, raw, priors, checks, np.stack(test_depth), \
        np.stack(test_mask)


def test_view_depth_mae(argv, ckpt, gt_depth, gt_mask):
    """Mean |rendered - analytic| ray depth in metres over the test views'
    pixels of opacity > 0.5 (render_test_fast, as validate renders)."""
    import train_torch
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    from google_nerf_tpu_torch.opt import get_opts
    from google_nerf_tpu_torch.train.system import init_train_state
    from google_nerf_tpu_torch.utils.ckpt import load_ckpt
    hp = get_opts(argv)
    dev = train_torch.device_of(hp)
    ds = train_torch.make_dataset(hp, "test", dev)
    cfg = train_torch.build_configs(hp)
    state = init_train_state(cfg, ds.K, ds.poses, ds.img_wh, device=dev)
    state = load_ckpt(ckpt, target=state)
    occ_u8 = train_torch.serving_words(state, cfg)
    dirs = torch.as_tensor(ds.directions, device=dev)
    errs = []
    with torch.no_grad():
        for i, pose in enumerate(torch.as_tensor(ds.poses, device=dev)):
            o, d = get_rays(dirs, pose)
            out = render_test_fast(state["params"], cfg.model, occ_u8, o, d,
                                   max_samples=cfg.max_samples)
            dep = out["depth"].cpu().numpy() * 2 * SCANNET_SCALE
            errs.append(np.abs(dep - gt_depth[i])[gt_mask[i]])
    return float(np.concatenate(errs).mean())


def phase13(seed, steps=DATA_STEPS, scan_root=None):
    """Datasets on disk through the CLIs, in a temporary directory:

      * NSVF: write_nsvf_scene, then train_torch.main at opt.py's
        defaults (--dataset_name nsvf, 800x800, full width) for `steps`
        steps, then test_torch.run's default renderer on the slim
        checkpoint;
      * ScanNet: write_scannet_scene, then train_scannet_torch.run at
        opt.py's defaults (640x480) twice from one seed, with the depth
        priors (--depth_dir, --depth_loss_w 0.1) and without
        (--depth_loss_w 0), then test_torch.run on the supervised slim
        checkpoint.

    Cut in depth only (NSVF_VIEWS, SCANNET_FRAMES, `steps`).  Each run has
    the kernel counters at 0 just before it (read just after).  Checks:
    every PNG decodes to the array written, every JPEG within the CPU
    test's 40 dB of its input, every prior within 1 mm; logged losses
    finite; the supervised run logs a nonzero depth term; the two
    ScanNet tables differ; validate PSNR >= 25 dB in the three runs; P2
    and P3 launched in each training run; test_torch's PSNR within 1 dB
    of validate's on the same checkpoint.  P2/P3 on the NSVF and the
    supervised ScanNet training steps join the kernels line (requests
    "nsvf" and "scannet").  The ScanNet scan is written under
    `scan_root` when one is given (it outlives the phase; phase 15 reads
    it), else in the phase's temporary directory.  Returns (summary,
    kernels-line entries, (scene dir, raw-scan root, priors dir))."""
    import os
    import tempfile

    from google_nerf_tpu_torch.data import dataset_dict
    from google_nerf_tpu_torch.utils.ckpt import load_ckpt
    dev = torch.device("cuda")
    run_steps = ["--num_epochs", "1", "--steps_per_epoch", str(steps),
                 "--seed", str(seed)]
    cut = (f"depth cut: {NSVF_VIEWS[0]} + {NSVF_VIEWS[1]} NSVF views "
           f"(Synthetic-NeRF: 100 + 200), {SCANNET_FRAMES[0]} + "
           f"{SCANNET_FRAMES[1]} ScanNet frames (a scan: hundreds), 1 "
           f"epoch of {steps} steps (opt.py: 30 x 1000); widths at opt.py's "
           "defaults")
    print(f"phase 13: {cut}", flush=True)
    summary, entries = dict(cut=cut), []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # ---- NSVF
            root = os.path.join(tmp, "data", "Synthetic_NeRF", "Procedural")
            t0 = time.time()
            wrote = write_nsvf_scene(root, seed, dev)
            wrote["write_s"] = time.time() - t0
            check(wrote["png_max_abs_err"] == 0,
                  f"phase 13: a PNG decoded {wrote['png_max_abs_err']} "
                  "from the array written")
            t0 = time.time()
            dataset_dict["nsvf"](root, split="train", device="cpu")
            load_s = time.time() - t0
            print(f"phase 13: nsvf scene: {wrote}; train split loaded in "
                  f"{load_s:.2f} s", flush=True)
            train, served, rows = cli_leg(
                "phase 13", "nsvf", ["--root_dir", root, "--dataset_name",
                                     "nsvf", "--exp_name", "nsvf"]
                + run_steps, request="nsvf", serve=(Serve("nsvf", gap=1.0),))
            entries += rows
            summary["nsvf"] = dict(scene=dict(wrote, load_s=load_s),
                                   train=train, serve=served["nsvf"])
            torch.cuda.empty_cache()

            # ---- ScanNet
            t0 = time.time()
            scene, raw, priors, wrote, gt_depth, gt_mask = \
                write_scannet_scene(scan_root or os.path.join(tmp, "data"),
                                    seed, dev)
            wrote["write_s"] = time.time() - t0
            check(wrote["jpeg_min_psnr"] >= JPEG_MIN_PSNR,
                  f"phase 13: a JPEG decoded at {wrote['jpeg_min_psnr']} dB "
                  "of its input")
            check(wrote["prior_png_max_abs_err"] == 0,
                  f"phase 13: a depth-prior PNG decoded "
                  f"{wrote['prior_png_max_abs_err']} from the array written")
            check(wrote["prior_max_err_mm"] <= 1.0,
                  f"phase 13: a depth prior read back "
                  f"{wrote['prior_max_err_mm']} mm off")
            t0 = time.time()
            dataset_dict["scannet"](scene, split="train", device="cpu",
                                    raw_scan_rootdir=raw, depth_dir=priors)
            load_s = time.time() - t0
            print(f"phase 13: scannet scene: {wrote}; train split with "
                  f"priors loaded in {load_s:.2f} s", flush=True)
            base = ["--root_dir", scene, "--dataset_name", "scannet",
                    "--raw_scan_rootdir", raw] + run_steps
            runs = {}
            for label, extra in (
                    ("sup", ["--depth_dir", priors, "--depth_loss_w",
                             "0.1"]),
                    ("nosup", ["--depth_loss_w", "0"])):
                sup = label == "sup"
                runs[label], served, rows = cli_leg(
                    "phase 13", f"scannet {label}",
                    base + extra + ["--exp_name", label],
                    request="scannet" if sup else None,
                    depth=(gt_depth, gt_mask),
                    serve=(Serve("scannet sup", gap=1.0),) if sup else ())
                entries += rows
                if sup:
                    summary["scannet"] = dict(scene=dict(wrote, load_s=load_s),
                                              train=runs,
                                              serve=served["scannet sup"])
            tabs = [load_ckpt(f"ckpts/scannet/{k}/epoch=0")["params"][
                "packed_table"] for k in ("sup", "nosup")]
            check(not torch.equal(tabs[0].cpu(), tabs[1].cpu()),
                  "phase 13: the supervised and unsupervised ScanNet "
                  "tables are equal")
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    return summary, entries, (scene, raw, priors)


# ------------------- phase 14: the other encoders and the block marcher

# (label, flags beyond opt.py's defaults, the module that calls the
# encoder's kernels, the wrappers it calls, the table's param key)
ENCODER_RUNS = (
    ("hash", ["--xyz_encoder", "hash"], "models.encoders",
     HASH_GRID_KERNELS, "hash_table"),
    ("freq", ["--xyz_encoder", "freq"], None, (), None),
    ("packed2", ["--xyz_encoder", "packed2"], "ops.packed_pair",
     ("gather_rows", "scatter_add_rows"), "pair_table"),
    ("block", ["--march", "block"], "ops.packed_hash",
     ("gather_rows", "scatter_add_rows"), "packed_table"))
EARLY_STEP = 64             # the freq run's train psnr is compared here
# the hash run keeps CLI_STEPS (it validated at 16.51 dB after 512); the
# others take DATA_STEPS to keep the script inside its time limit as
# phase 20 joined
HASH_STEPS = CLI_STEPS


def steps_metrics(tsys, at, run):
    """run() with the train psnr read at fused step `at` (one host read);
    returns (run's result, that psnr)."""
    step_fn, seen = tsys.fused_train_step, [0, None]

    def step(*a, **k):
        out = step_fn(*a, **k)
        seen[0] += 1
        if seen[0] == at:
            seen[1] = float(out[1]["psnr"])
        return out

    tsys.fused_train_step = step
    try:
        return run(), seen[1]
    finally:
        tsys.fused_train_step = step_fn


def restored_state(argv, ckpt, dev, split=None):
    """The train state of a checkpoint written by train_torch.main(argv),
    its marching tables repacked, and the scene of the run's split (or of
    `split`) and config."""
    import train_torch
    from google_nerf_tpu_torch.opt import get_opts
    from google_nerf_tpu_torch.train import system as tsys
    from google_nerf_tpu_torch.utils.ckpt import load_ckpt
    hp = get_opts(argv)
    cfg = train_torch.build_configs(hp)
    ds = train_torch.make_dataset(hp, split or hp.split, dev)
    state = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                                  generator=torch.Generator().manual_seed(0),
                                  device=dev)
    state = load_ckpt(ckpt, target=state)
    state["occ_u8"] = tsys.pack_marching_grid(state["occ"], cfg)
    return state, ds.scene(), cfg


def phase14(seed, steps=DATA_STEPS):
    """The other xyz encoders and the one-phase block marcher through the
    CLIs, in a temporary directory, each as phase 12's training run
    (train_torch.main at opt.py's defaults on the textured scene at 256^2,
    1 epoch of `steps`, HASH_STEPS for hash) with one flag changed:
    --xyz_encoder hash (16 levels of 2^19 x 2, P3 for the table
    gradient; its forward gather is index_select, as JAX's is XLA's),
    freq (12 bands, no table, no kernel), packed2 (4 pair tables of
    2^16 x 70, P2 on a copy padded to 72 columns, P3) and --march block
    (the packed encoder, P2 and P3); then test_torch.run's default
    renderer (oneshot) on each slim checkpoint, with --march block
    serving on the block rows.  The kernel
    counters are at 0 just before each run (read just after).

    Checks: P2/P3 launched in training where the encoder calls them;
    validate PSNR >= 25 dB for hash, packed2 and block; the freq run's
    validate PSNR finite and above its train PSNR at step 64; every
    served PSNR finite; the block serve marched with the block marcher
    and never the segment marcher.  For hash and packed2 one step from
    the trained state with the kernels against one with their plain
    versions (phase 9's bounds), and P2/P3 on the last training step's
    calls on the kernels line (requests "hash", "packed2").  Returns
    (summary, kernels-line entries)."""
    import os
    import tempfile
    cut = (f"depth cut: 1 epoch of {HASH_STEPS} steps for hash, {steps} "
           "for the others (opt.py: 30 x 1000); widths at opt.py's defaults")
    print(f"phase 14: {cut}", flush=True)
    summary, entries = dict(cut=cut, steps=steps), []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for label, flags, *encoder in ENCODER_RUNS:
                n_steps = HASH_STEPS if label == "hash" else steps
                timed = label in ("hash", "packed2")
                info, served, rows = cli_leg(
                    "phase 14", label, CLI_SCENE + flags + [
                        "--num_epochs", "1", "--steps_per_epoch",
                        str(n_steps), "--seed", str(seed), "--exp_name",
                        label, "--no_save_test"],
                    encoder=encoder, request=label if timed else None,
                    early_at=EARLY_STEP,
                    psnr_ok=(lambda psnr, early: psnr > early)
                    if label == "freq" else None,
                    serve=(Serve(label, launched=(), marches=True),),
                    step=(seed + 14, None) if timed else None)
                entries += rows
                summary[label] = dict(info, serve=served[label])
                torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    return summary, entries


# ------------------------------- phase 15: the depth-prior path, LeReS

DEPTH_BACKBONE = "resnext101"     # the CLIs' default: ResNeXt101-32x8d
DEPTH_LATENT = 32                 # --d_latent's default: cIMLE on
DEPTH_CROP = 448                  # --crop_size's default
DEPTH_SAMPLES = 10                # two minibatches of 5 a frame
DEPTH_CPU_REL = 1e-4              # card vs CPU, tests/test_torch_cuda.py's
DEPTH_REPS = 5                    # frames timed for the forward alone


def forward_flops(model, rgb, z):
    """Multiply-adds x 2 of every convolution and linear layer in one
    forward of model on rgb (the elementwise work, BatchNorm, the
    upsampling and the pooling, is left out)."""
    from google_nerf_tpu_torch.depth.model import depth_forward
    total = [0]

    def conv(m, args, out):
        total[0] += 2 * out.numel() * m.weight[0].numel()

    def linear(m, args, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d)
                                     else linear)
             for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        depth_forward(model, rgb, z)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


# the decoder's 3x3s timed in phase 15, (Cin, Cout, side) at a minibatch
# of 5 and a 448^2 crop: the FTB's first at 14^2 and the 1/2 FFM's at
# 28^2 (both split over K: 8 and 4 ways on 132 SMs), the 1/4 FFMs' and
# the AO head's
C3_SHAPES = ((2048, 512, 14), (1024, 256, 28), (256, 256, 112),
             (256, 128, 224), (128, 1, 224))
C3_MINIBATCH = 5
C3_REL = 1e-4        # kernel vs plain (cuDNN f32, TF32 off), norm-relative
C3_REPS = 20


def conv3x3_entries(seed, launches, shapes=C3_SHAPES):
    """The decoder's 3x3 kernels (ops/cuda/conv3x3) at each (Cin, Cout,
    side): the output held to the plain version (cuDNN's F.conv2d in f32
    with TF32 off on the card) within C3_REL, norm-relative; then its
    kernel_row: the device ms of the kernels a call launches (the
    weights' pack, the GEMM and, where `plan` splits K, the fixed-order
    sum; or the Cout-1 kernel), the bound, the larger of the bytes'
    (input, weights, bias and output once) and the operations' (2 x MACs
    at the f32 peak), the plain version's ms, which is also library_ms.
    A split shape must launch the sum, and no other shape.  `launches`
    is the CLI run's count, on every row.  Returns the kernels-line
    entries."""
    from google_nerf_tpu_torch.ops.conv3x3 import conv3x3_plain
    from google_nerf_tpu_torch.ops.cuda.conv3x3 import _sms, conv3x3, plan
    from google_nerf_tpu_torch.utils.precision import exact_f32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for cin, cout, side in shapes:
        x = torch.randn((C3_MINIBATCH, cin, side, side), generator=gen,
                        device=dev)
        w = torch.randn((cout, cin, 3, 3), generator=gen,
                        device=dev) / (3 * cin ** 0.5)
        b = torch.randn((cout,), generator=gen, device=dev)
        request = f"{cin}->{cout} at {side}^2 x{C3_MINIBATCH}"
        splits = 1 if cout == 1 else plan(C3_MINIBATCH, cin, side, side,
                                          cout, _sms(0))["splits"]
        kernels = (("conv3x3_cout1",) if cout == 1 else
                   ("conv3x3_gemm", "conv3x3_pack")
                   + ("conv3x3_reduce",) * (splits > 1))
        macs = C3_MINIBATCH * side * side * cout * cin * 9
        nbytes = 4 * (C3_MINIBATCH * (cin + cout) * side * side
                      + cout * cin * 9 + cout)
        with exact_f32():
            got, want = conv3x3(x, w, b), conv3x3_plain(x, w, b)
            rel = float((got - want).norm() / want.norm())
            err = float((got - want).abs().max())
            check(rel <= C3_REL, f"conv3x3 {request}: {rel:.2e} from the "
                  f"plain version")
            row, ops = kernel_row(
                "phase 15", lambda: conv3x3(x, w, b),
                lambda: conv3x3_plain(x, w, b), kernels,
                (nbytes, 2 * macs), reps=C3_REPS, name="conv3x3", id="C3",
                source=f"{CSRC}/conv3x3.cu",
                replaces="none (XLA in google_nerf_tpu/depth/decoder.py)",
                launches=launches, max_abs_err=err, rel_to_plain=rel,
                library="cuDNN F.conv2d, f32, TF32 off", request=request,
                splits=splits)
        ops = [k for k in ops if "conv3x3" in k]
        reduced = any("conv3x3_reduce" in k for k in ops)
        check(reduced == (splits > 1), f"conv3x3 {request}: {splits} "
              f"splits over K, the sum launched: {reduced}")
        row.update(launches_a_call=len(ops), tflops=2e-9 * macs / row["ms"])
        out.append(row)
        print(f"phase 15: C3 {request}: {row['tflops']:.1f} TFLOP/s, "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bound; "
              f"{splits} split(s) over K; {rel:.2e} from the plain version",
              flush=True)
    return out


def phase15(seed, scan=None):
    """The depth-prior path: depth_eval_scannet_torch.main at the CLIs'
    defaults (ResNeXt101-32x8d, encoder-site cIMLE at d_latent 32, crop
    448) with --num_samples 10 (two minibatches of 5 a frame) and
    --save_rainbow on phase 13's ScanNet scan (`scan`: its scene dir,
    raw-scan root and 640x480 mm PNG priors; written anew when None),
    the PNGs served as the scan's depth/ ground truth.  The model is
    random from `seed` (no reference weights are in the repo), saved as
    JAX's .npz and passed as --load_ckpt.

    Checks: every frame's prior finite and positive, 968x1296, at or
    above 0.01; every minibatch of 5 with its minimum at 0.01 (recorded
    from the CLI's depth_inference calls); frame 0's first minibatch on
    the card against the same model and latents on the CPU
    (norm-relative DEPTH_CPU_REL); its five latents give five different
    priors; the priors load through ScannetDataset(depth_dir=...) at
    640x480, finite; the metric battery finite; the CLI's frames
    launched the decoder's 3x3 kernels (ops/cuda/conv3x3: their count
    set to 0 just before the CLI runs), which conv3x3_entries then times
    and holds to their plain version.  Returns the summary and the
    kernels-line entries."""
    import os
    import tempfile

    import depth_eval_scannet_torch
    import depth_test_torch
    from google_nerf_tpu_torch.convert import save_depth_npz
    from google_nerf_tpu_torch.data import dataset_dict
    from google_nerf_tpu_torch.depth import priors
    from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                                   depth_inference,
                                                   init_depth_model)
    from google_nerf_tpu_torch.depth.weights import load_checkpoint
    from google_nerf_tpu_torch.ops.cuda.conv3x3 import conv3x3
    from google_nerf_tpu_torch.utils.image import resize_linear
    dev = torch.device("cuda")
    arch = depth_test_torch.BACKBONES[DEPTH_BACKBONE]
    cfg = DepthModelConfig(backbone=arch, d_latent=DEPTH_LATENT)
    with tempfile.TemporaryDirectory() as tmp:
        if scan is None:
            scene, raw, gt, *_ = write_scannet_scene(
                os.path.join(tmp, "data"), seed, dev)
        else:
            scene, raw, gt = scan
        os.symlink(gt, os.path.join(scene, "depth"))
        t0 = time.time()
        model = init_depth_model(torch.Generator().manual_seed(seed), cfg,
                                 "cpu")
        ckpt = os.path.join(tmp, "depth_cimle.npz")
        save_depth_npz(ckpt, model.state_dict())
        save_s = time.time() - t0
        n_params = sum(p.numel() for p in model.parameters())
        print(f"phase 15: {arch} cIMLE d_latent {DEPTH_LATENT}, "
              f"{n_params:,} parameters, random from seed {seed}; built "
              f"and saved as .npz in {save_s:.1f} s", flush=True)

        mins, shapes = [], []
        infer = priors.depth_inference

        def recording(m, rgb01, z=None, *forward):
            out = infer(m, rgb01, z, *forward)
            mins.append(out.amin())
            shapes.append(tuple(out.shape))
            check(out.is_cuda, "phase 15: the depth forward ran off the card")
            return out

        out_dir = os.path.join(tmp, "priors")
        argv = ["--scene_dir", scene, "--out_dir", out_dir, "--load_ckpt",
                ckpt, "--backbone", DEPTH_BACKBONE, "--d_latent",
                str(DEPTH_LATENT), "--crop_size", str(DEPTH_CROP),
                "--num_samples", str(DEPTH_SAMPLES), "--save_rainbow",
                "--seed", str(seed)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        priors.depth_inference = recording
        conv3x3.launches = 0
        t0 = time.time()
        try:
            run = depth_eval_scannet_torch.main(argv)
        finally:
            priors.depth_inference = infer
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        c3_launches = conv3x3.launches
        check(c3_launches > 0, "phase 15: the decoder's 3x3s never ran "
              "the conv3x3 kernels")
        frames = sorted(f[:-4] for f in os.listdir(out_dir)
                        if f.endswith(".npy"))
        check(run["frames"] == len(frames) == sum(SCANNET_FRAMES),
              f"phase 15: {run['frames']} frames run, {len(frames)} priors")
        check(shapes == [(5, 1, DEPTH_CROP, DEPTH_CROP)] * (2 * len(frames)),
              f"phase 15: minibatches {sorted(set(shapes))}, "
              f"{len(shapes)} of them")
        mins = torch.stack(mins).cpu()
        check(bool(((mins - 0.01).abs() <= 1e-6).all()),
              f"phase 15: minibatch minima {mins.min()}..{mins.max()}")
        cw, ch = SCANNET_COLOR_WH
        lo = hi = None
        for f in frames:
            d = np.load(os.path.join(out_dir, f + ".npy"))
            check(d.shape == (ch, cw) and bool(np.isfinite(d).all())
                  and float(d.min()) >= 0.01 - 1e-6,
                  f"phase 15: prior {f} shape {d.shape}, range "
                  f"{d.min()}..{d.max()}")
            check(os.path.exists(os.path.join(out_dir,
                                              f + "-depth_rainbow.png")),
                  f"phase 15: no rainbow PNG for frame {f}")
            lo = d.min() if lo is None else min(lo, d.min())
            hi = d.max() if hi is None else max(hi, d.max())
        metrics = run["metrics"]
        check(len(metrics) == 10 and all(math.isfinite(v)
                                         for v in metrics.values()),
              f"phase 15: metric battery {metrics}")
        ds = dataset_dict["scannet"](scene, split="train", device="cpu",
                                     raw_scan_rootdir=raw, depth_dir=out_dir)
        check(ds.img_wh == (640, 480) and ds.depths.shape[1] == 640 * 480
              and bool(np.isfinite(ds.depths).all())
              and float(ds.depths.min()) > 0,
              f"phase 15: ScannetDataset read the priors as "
              f"{ds.depths.shape}, finite {np.isfinite(ds.depths).all()}")

        # frame 0's first minibatch: the card against the CPU
        cpu = init_depth_model(torch.Generator().manual_seed(0), cfg, "cpu")
        load_checkpoint(cpu, ckpt)
        card = init_depth_model(torch.Generator().manual_seed(0), cfg, dev)
        load_checkpoint(card, ckpt)
        rgb = depth_test_torch.read_rgb01(os.path.join(scene, "rgb",
                                                       frames[0] + ".jpg"))
        inp = resize_linear(torch.from_numpy(rgb), (DEPTH_CROP, DEPTH_CROP))
        inp = inp.permute(2, 0, 1)[None].expand(5, -1, -1, -1).contiguous()
        z = torch.randn((5, DEPTH_LATENT),
                        generator=torch.Generator().manual_seed(seed + 1))
        t0 = time.time()
        want = depth_inference(cpu, inp, z)
        cpu_s = time.time() - t0
        got = depth_inference(card, inp.to(dev), z.to(dev)).cpu()
        rel = float((got - want).norm() / want.norm())
        check(rel <= DEPTH_CPU_REL, f"phase 15: card vs CPU forward {rel}")
        spread = float((got[1:] - got[:1]).abs().amax(dim=(1, 2, 3)).min())
        check(spread > 1e-3 * float(got.abs().max()),
              f"phase 15: two latents gave one prior (max diff {spread})")
        del cpu

        # the forward alone: 10 hypotheses (two minibatches) a frame
        x, zc = inp.to(dev), z.to(dev)
        flops = forward_flops(card, x[:1], zc[:1])

        def frame():
            depth_inference(card, x, zc)
            depth_inference(card, x, zc)

        fwd_ms = cuda_ms(frame, DEPTH_REPS)
        frame_ms = [1e3 * s for s in run["frame_s"]]
        med = statistics.median(frame_ms)
        share = (flops * DEPTH_SAMPLES / (fwd_ms * 1e-3)
                 / PEAKS["flops_per_s"]["float32"])
    c3_entries = conv3x3_entries(seed, c3_launches)
    out = dict(arch=arch, d_latent=DEPTH_LATENT, crop=DEPTH_CROP,
               samples=DEPTH_SAMPLES, frames=len(frames),
               n_params=n_params, cli_wall_s=wall,
               cli_frame_ms=frame_ms, cli_frame_ms_median=med,
               frames_per_s=1e3 / med, images_per_s=DEPTH_SAMPLES * 1e3 / med,
               forward_ms_per_frame=fwd_ms,
               forward_images_per_s=DEPTH_SAMPLES * 1e3 / fwd_ms,
               gflop_per_image=flops / 1e9, f32_peak_share=share,
               peak_gib=peak_gib, build_s=run["build_s"],
               load_s=run["load_s"], save_s=save_s, card_vs_cpu_rel=rel,
               cpu_forward_s=cpu_s, latent_spread=spread,
               prior_range=[float(lo), float(hi)], metrics=metrics,
               conv3x3_launches=c3_launches)
    print(f"phase 15: depth_eval_scannet_torch on {len(frames)} frames of "
          f"{cw}x{ch}, {DEPTH_SAMPLES} hypotheses a frame: {wall:.1f} s "
          f"(model build {run['build_s']:.2f} s, weight load "
          f"{run['load_s']:.2f} s); a frame {med:.1f} ms median "
          f"({1e3 / med:.2f} frames/s, {DEPTH_SAMPLES * 1e3 / med:.1f} "
          f"images/s); the forward alone {fwd_ms:.2f} ms a frame "
          f"({DEPTH_SAMPLES * 1e3 / fwd_ms:.1f} images/s), "
          f"{flops / 1e9:.1f} GFLOP an image, {100 * share:.1f}% of the "
          f"f32 peak; peak memory {peak_gib:.2f} GiB; card vs CPU "
          f"{rel:.2e}; prior range {lo:.4f}..{hi:.4f}; metrics "
          f"{ {k: round(v, 4) for k, v in metrics.items()} }; conv3x3 "
          f"launches {c3_launches}", flush=True)
    return out, c3_entries


# ------------------------------ phase 16: the cIMLE depth trainer, LeReS

DEPTH_TRAIN_FRAMES = (4, 2)       # train, test frames of phase 13's scan
                                  # (8, 4 until phase 20 joined)
DEPTH_F64_REL = 1e-9              # card vs CPU float64 step, each tensor
DEPTH_F32_TENSOR = 6e-2           # card float32 vs float64, each tensor
DEPTH_F32_GLOBAL = 5e-2           # and over all (card_vs_cpu_step)
DEPTH_TRAIN_EPOCHS = 2            # --epoch (the CLI's default: 50)
DEPTH_EVAL_SAMPLES = 10           # depth_eval_torch.py --num_samples


def write_depth_annotations(root, scene, priors):
    """An annotation dataset `scannet_frames` over phase 13's scan: the
    first DEPTH_TRAIN_FRAMES[0] frames' JPEGs and 16-bit mm PNG priors for
    train, the next DEPTH_TRAIN_FRAMES[1] for test (absolute paths)."""
    import json
    import os
    ids = sorted(int(f[:-4]) for f in os.listdir(os.path.join(scene, "rgb"))
                 if f.endswith(".jpg"))
    n_train, n_test = DEPTH_TRAIN_FRAMES
    adir = os.path.join(root, "scannet_frames", "annotations")
    os.makedirs(adir)
    for split, sel in (("train", ids[:n_train]),
                       ("test", ids[n_train:n_train + n_test])):
        with open(os.path.join(adir, f"{split}_annotations.json"), "w") as f:
            json.dump([{"rgb_path": os.path.join(scene, "rgb", f"{i}.jpg"),
                        "depth_path": os.path.join(priors, f"{i}.png")}
                       for i in sel], f)
    return root


def card_vs_cpu_step(model, cfg, data, z, draws, what):
    """One train step on the card and on the CPU, each in float32 and in
    float64, held to the CPU's float64 step over compared_keys (every
    gradient that is not zero in exact arithmetic;
    tools/depth_step_precision.compare): the two float32 losses within
    DEPTH_CPU_REL; the card's float64 step within DEPTH_F64_REL of the
    CPU's (the loss, each tensor's gradient and momentum trace: the same
    function on the card); the card's float32 gradients and traces
    within DEPTH_F32_TENSOR of float64 for each tensor and
    DEPTH_F32_GLOBAL over all.  Float32 cannot meet 1e-4 here: train-mode
    BatchNorm's backward pass loses ~2-3% on every tensor at this width
    and a batch of 1, on the CPU as on the card (PERF.md section 6;
    phase 16 read 2.7e-2 per tensor and 2.4e-2 over all on the card, the
    float64 steps 2.0e-10 apart), and TF32 in the step would miss by
    1.12.  Returns the readings."""
    from google_nerf_tpu_torch.tools.depth_step_precision import compare
    r = compare(cfg, model, data, z, draws, "cuda")
    f64, f32 = r["card_f64"], r["card"]
    check(r["loss_card_vs_cpu"] <= DEPTH_CPU_REL
          and max(f64["loss"], f64["grads_tensor_max"],
                  f64["traces_tensor_max"]) <= DEPTH_F64_REL
          and max(f32["grads_tensor_max"],
                  f32["traces_tensor_max"]) <= DEPTH_F32_TENSOR
          and max(f32["grads"], f32["traces"]) <= DEPTH_F32_GLOBAL,
          f"{what}: card vs CPU step {r}")
    return r


def phase16(seed, scan):
    """The cIMLE depth trainer: depth_train_torch.py at the CLI's defaults
    (ResNeXt101-32x8d, --cimle_version v2: encoder-site AdaIN at d_latent
    32, crop 448, --batchsize 2, the default loss mode, 20 latents an
    image in minibatches of 5 at the recache) on an annotation dataset
    over phase 13's scan (`scan`: its scene dir, raw root and 640x480 mm
    PNG priors), random init from `seed`.  Cut: --epoch DEPTH_TRAIN_EPOCHS
    and the frames (DEPTH_TRAIN_FRAMES; a dataset: thousands); set for the
    checks: --options TRAIN.CKPT_EPOCHS 1 (the default 8 would write none
    in 2 epochs).

    Checks: the loss finite at every step; epoch1.npz, epoch2.npz,
    final.npz and resume_epoch1 written; --resume resume_epoch1 runs
    epoch 1's steps only, to the same step count, finite; one full-width
    train step on a batch of 1 (the first train item, seeded latent and
    loss draws) on the card against the CPU (card_vs_cpu_step);
    depth_eval_torch.py --num_samples 10 --select loss on final.npz over
    the test frames: a finite battery of 10 metrics.  Reported: recache ms per
    image-hypothesis, train ms a step (median after the first) and
    images/s, GFLOP a step (3 x the forward's convolution and linear
    multiply-adds x 2 per image) and its share of the f32 peak, peak
    memory, the phase's seconds; the decoder's 3x3 kernel launches
    (ops/cuda/conv3x3) of the first training run and of the evaluation,
    each count set to 0 just before, both above 0: the recache
    (trainer.zcache_losses) and the evaluation record no gradient and so
    run the kernel, the step's forward and backward keep nn.Conv2d.  The
    rest of the network is cuDNN's convolutions in f32 with TF32 off, as
    JAX leaves it to XLA."""
    import os
    import tempfile

    import depth_eval_torch
    import depth_train_torch
    from google_nerf_tpu_torch.depth import trainer
    from google_nerf_tpu_torch.depth.data import (DepthAnnotationDataset,
                                                  MultiDatasetSampler)
    from google_nerf_tpu_torch.depth.losses import loss_draws
    from google_nerf_tpu_torch.ops.cuda.conv3x3 import conv3x3
    dev = torch.device("cuda")
    t_phase = time.time()
    scene, _, priors = scan
    with tempfile.TemporaryDirectory() as tmp:
        root = write_depth_annotations(os.path.join(tmp, "data"), scene,
                                       priors)
        out = os.path.join(tmp, "run")

        def argv_to(out_dir):
            return ["--dataroot", root, "--dataset_list", "scannet_frames",
                    "--epoch", str(DEPTH_TRAIN_EPOCHS), "--out_dir", out_dir,
                    "--seed", str(seed), "--platform", "cuda", "--options",
                    "TRAIN.CKPT_EPOCHS", "1"]

        argv = argv_to(out)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        conv3x3.launches = 0
        run = depth_train_torch.main(argv)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        train_c3 = conv3x3.launches
        check(train_c3 > 0, "phase 16: the recache never ran the conv3x3 "
              "kernels")
        args = depth_train_torch.get_args(argv)
        cfg = depth_train_torch.build_cfg(args)
        t = cfg.train
        steps = [h for h in run["history"] if h["kind"] == "step"]
        recache = [h for h in run["history"] if h["kind"] == "recache"]
        n_steps = DEPTH_TRAIN_EPOCHS * (DEPTH_TRAIN_FRAMES[0] // t.batch_size)
        check(len(steps) == run["state"].step == n_steps,
              f"phase 16: {len(steps)} steps, state at {run['state'].step}")
        check(all(math.isfinite(h["total_loss"]) for h in steps),
              f"phase 16: losses {[h['total_loss'] for h in steps]}")
        for name in ("epoch1.npz", "epoch2.npz", "final.npz",
                     "resume_epoch1"):
            check(os.path.exists(os.path.join(out, name)),
                  f"phase 16: {name} not written")
        step_ms = [1e3 * h["seconds"] for h in steps]
        med_ms = statistics.median(step_ms[1:])
        recache_ms = 1e3 * recache[0]["seconds"] / (recache[0]["images"]
                                                    * t.num_latent)
        print(f"phase 16: {n_steps} steps, losses "
              f"{[round(h['total_loss'], 4) for h in steps]}; step ms "
              f"{[round(x, 1) for x in step_ms]}; recache "
              f"{recache[0]['seconds']:.2f} s; conv3x3 launches "
              f"{train_c3}", flush=True)
        model = run["state"].model
        del run

        # --resume from epoch 1: epoch 2's steps only
        again = depth_train_torch.main(
            argv_to(os.path.join(tmp, "again"))
            + ["--resume", os.path.join(out, "resume_epoch1")])
        resumed = [(h["epoch"], h["step"], h["total_loss"])
                   for h in again["history"] if h["kind"] == "step"]
        check(again["state"].step == n_steps
              and {e for e, _, _ in resumed} == {1}
              and len(resumed) == n_steps // DEPTH_TRAIN_EPOCHS
              and all(math.isfinite(x) for _, _, x in resumed),
              f"phase 16: --resume ran (epoch, step, loss) {resumed} to "
              f"step {again['state'].step}")
        del again

        # one full-width step on a batch of 1: the card against the CPU
        ds = DepthAnnotationDataset(root, "scannet_frames", cfg=cfg.dataset)
        batch = next(MultiDatasetSampler([ds], seed=seed).batches(0, 1))
        data = trainer.batch_to_device(batch, "cpu")
        gen = torch.Generator().manual_seed(seed + 1)
        z = torch.randn((1, cfg.model.d_latent), generator=gen)
        draws = loss_draws(1, *cfg.dataset.crop_size, t.loss_mode, gen,
                           "cpu")
        init = trainer.init_trainer(seed, cfg, "cpu")[0].model
        step = card_vs_cpu_step(init, cfg, data, z, draws, "phase 16")
        del init

        # the FLOPs of a step: 3 x the forward's per image
        x = data["rgb"].to(dev)
        flops = 3 * forward_flops(model, x, z.to(dev)) * t.batch_size
        share = flops / (med_ms * 1e-3) / PEAKS["flops_per_s"]["float32"]
        del model
        torch.cuda.empty_cache()

        # the evaluation CLI on final.npz over the test frames
        conv3x3.launches = 0
        ev = depth_eval_torch.main(
            ["--dataroot", root, "--dataset", "scannet_frames",
             "--load_ckpt", os.path.join(out, "final.npz"), "--backbone",
             args.backbone, "--crop_size", str(args.crop_size),
             "--d_latent", str(cfg.model.d_latent), "--num_samples",
             str(DEPTH_EVAL_SAMPLES), "--select", "loss", "--seed",
             str(seed), "--platform", "cuda"])
        eval_c3 = conv3x3.launches
        check(eval_c3 > 0, "phase 16: the evaluation never ran the conv3x3 "
              "kernels")
        metrics = ev["metrics"]
        check(ev["images"] == DEPTH_TRAIN_FRAMES[1] and len(metrics) == 10
              and all(math.isfinite(v) for v in metrics.values()),
              f"phase 16: eval battery {metrics}")
    seconds = time.time() - t_phase
    out = dict(arch=cfg.model.encoder, d_latent=cfg.model.d_latent,
               crop=cfg.dataset.crop_size, batch=t.batch_size,
               frames=DEPTH_TRAIN_FRAMES, epochs=DEPTH_TRAIN_EPOCHS,
               losses=[h["total_loss"] for h in steps], step_ms=step_ms,
               step_ms_median=med_ms,
               images_per_s=t.batch_size * 1e3 / med_ms,
               recache_s=recache[0]["seconds"],
               recache_ms_per_image_hypothesis=recache_ms,
               gflop_per_step=flops / 1e9, f32_peak_share=share,
               peak_gib=peak_gib, card_vs_cpu=step, eval_metrics=metrics,
               eval_image_ms=[1e3 * s for s in ev["image_s"]],
               conv3x3_launches=dict(train=train_c3, eval=eval_c3),
               seconds=seconds)
    f64, f32, cpu = step["card_f64"], step["card"], step["cpu"]
    print(f"phase 16: depth_train_torch {cfg.model.encoder} cIMLE d_latent "
          f"{cfg.model.d_latent} at {cfg.dataset.crop_size[0]}^2, batch "
          f"{t.batch_size}, {DEPTH_TRAIN_FRAMES[0]} frames x "
          f"{DEPTH_TRAIN_EPOCHS} epochs: a step {med_ms:.1f} ms median "
          f"({t.batch_size * 1e3 / med_ms:.2f} images/s), {flops / 1e9:.1f} "
          f"GFLOP a step, {100 * share:.1f}% of the f32 peak; recache "
          f"{recache_ms:.2f} ms an image-hypothesis; peak memory "
          f"{peak_gib:.2f} GiB; card vs CPU step (batch 1, "
          f"{step['n_compared']} tensors): loss "
          f"{step['loss_card_vs_cpu']:.2e}, card float64 vs CPU float64 "
          f"{f64['loss']:.2e} (loss), {f64['grads_tensor_max']:.2e} "
          f"(gradients, largest tensor), {f64['traces_tensor_max']:.2e} "
          f"(traces); float32 vs float64 gradients card {f32['grads']:.2e} "
          f"(largest tensor {f32['grads_tensor_max']:.2e}), CPU "
          f"{cpu['grads']:.2e} ({cpu['grads_tensor_max']:.2e}), traces "
          f"card {f32['traces']:.2e} ({f32['traces_tensor_max']:.2e})"
          f"; eval --select loss over "
          f"{DEPTH_TRAIN_FRAMES[1]} frames "
          f"{ {k: round(v, 4) for k, v in metrics.items()} }; conv3x3 "
          f"launches: training run {train_c3}, evaluation {eval_c3}; phase "
          f"{seconds:.1f} s", flush=True)
    return out


# --------------------------- phase 17: the .sens chain, scannet_tools

# process_scene's frame skip (its default, 10, is for a scan of
# thousands of frames): the packed scan holds phase 13's 28, and every
# one is kept, so that the training sees phase 13's view density (at a
# skip of 2, 12 training views validated at 14.95 dB after 256 steps)
SENS_FRAME_SKIP = 1
SENS_TEST_STEP = 10               # split_train_test's; the loader's test_skip
SENS_STEPS = 512                  # a short run (opt.py: 30 x 1000)


def write_scan_sens(path, scene, priors):
    """Phase 13's scan packed into a v4 .sens by the port's write_sens:
    its 1296x968 colour JPEGs as they are, its 640x480 mm PNG priors as
    the zlib depth (depth_shift 1000), its poses, K of the depth frame
    (intrinsic_depth.txt) and of the colour frame (scaled to 1296x968).
    Returns (frames written, seconds)."""
    import os

    from google_nerf_tpu_torch.scannet_tools.sensor_data import write_sens
    from google_nerf_tpu_torch.utils.image import read_image
    ids = sorted(int(f[:-4]) for f in os.listdir(os.path.join(scene, "rgb")))
    Kd = np.loadtxt(os.path.join(scene, "intrinsic_depth.txt"))
    Kc = Kd.copy()
    Kc[0] *= SCANNET_COLOR_WH[0] / 640
    Kc[1] *= SCANNET_COLOR_WH[1] / 480
    t0 = time.time()
    frames = []
    for i in ids:
        with open(os.path.join(scene, "rgb", f"{i}.jpg"), "rb") as f:
            jpg = f.read()
        frames.append((np.loadtxt(os.path.join(scene, "pose", f"{i}.txt")),
                       jpg, read_image(os.path.join(priors, f"{i}.png"))))
    write_sens(path, intrinsic_color=Kc, intrinsic_depth=Kd,
               color_wh=SCANNET_COLOR_WH, depth_wh=(640, 480),
               depth_shift=1000.0, frames=frames)
    return frames, time.time() - t0


def sens_export(tmp, scan):
    """Phase 17's first half, under `tmp`: write_scan_sens, the decode
    checks, process_scene and split_train_test, and ScannetDataset on the
    export with its depth PNGs as the priors.  Returns (frames written,
    the export's directory, train ids, test ids, the summary)."""
    import os
    import zlib

    from google_nerf_tpu_torch.data.scannet import ScannetDataset
    from google_nerf_tpu_torch.scannet_tools import native
    from google_nerf_tpu_torch.scannet_tools.process import (
        process_scene, split_train_test)
    from google_nerf_tpu_torch.scannet_tools.sensor_data import SensorData
    from google_nerf_tpu_torch.utils.image import read_image
    scene_in, raw, priors = scan
    name = os.path.basename(os.path.normpath(scene_in))
    summary = {}
    sens = os.path.join(tmp, f"{name}.sens")
    frames, write_s = write_scan_sens(sens, scene_in, priors)
    n = len(frames)
    summary["sens_bytes"] = os.path.getsize(sens)

    # ---- decode
    sd = SensorData(sens)
    try:
        check((sd.num_frames, sd.color_width, sd.color_height,
               sd.depth_width, sd.depth_height, sd.depth_shift,
               sd.color_compression_type, sd.depth_compression_type)
              == (n, SCANNET_COLOR_WH[0], SCANNET_COLOR_WH[1], 640, 480,
                  1000.0, "jpeg", "zlib_ushort"),
              "phase 17: the .sens header is not what was written")
        check(np.allclose(sd.intrinsic_depth[:3, :3], SCANNET_K),
              "phase 17: intrinsic_depth is not the scan's K")
        t0 = time.time()
        frs = list(sd.iter_frames())
        index_s = time.time() - t0
        t0 = time.time()
        bulk = native.zlib_decompress_batch(
            [f.depth_data for f in frs], 640 * 480 * 2)
        batch_s = time.time() - t0
        t0 = time.time()
        single = [f.depth_image("zlib_ushort", 480, 640) for f in frs]
        single_s = time.time() - t0
        t0 = time.time()
        py = [zlib.decompress(f.depth_data) for f in frs]
        python_s = time.time() - t0
        for k, f in enumerate(frs):
            check(bulk[k].tobytes() == py[k]
                  and np.array_equal(single[k], frames[k][2])
                  and np.array_equal(f.camera_to_world,
                                     np.float32(frames[k][0])),
                  f"phase 17: .sens frame {k} decodes to other data")
        t0 = time.time()
        colours = [f.decompress_color("jpeg") for f in frs]
        colour_s = time.time() - t0
        check(all(c.shape == (968, 1296, 3) for c in colours),
              "phase 17: a colour frame decoded to another shape")
    finally:
        sd.close()
    del frs, bulk, single, py, colours
    decode = dict(depth_batch_ms=1e3 * batch_s / n,
                  depth_single_ms=1e3 * single_s / n,
                  depth_python_zlib_ms=1e3 * python_s / n,
                  colour_ms=1e3 * colour_s / n,
                  frame_walk_ms=1e3 * index_s / n)
    print(f"phase 17: wrote {n} frames ({summary['sens_bytes']} bytes) "
          f"in {write_s:.2f} s; decode ms a frame {decode}", flush=True)

    # ---- export and split
    out = os.path.join(tmp, "scans_processed", name)
    t0 = time.time()
    process_scene(sens, out, frame_skip=SENS_FRAME_SKIP,
                  image_size=(480, 640))
    export_s = time.time() - t0
    train_ids, test_ids = split_train_test(out, SENS_TEST_STEP)
    kept = list(range(0, n, SENS_FRAME_SKIP))
    check(sorted(train_ids + test_ids) == kept and test_ids,
          f"phase 17: split {train_ids} / {test_ids} of {kept}")
    for k in kept:
        dep = read_image(os.path.join(out, "depth", f"{k}.png"))
        check(np.array_equal(dep, frames[k][2]),
              f"phase 17: exported depth {k} is not the frame's")
        check(read_image(os.path.join(out, "rgb", f"{k}.jpg")).shape
              == (480, 640, 3), f"phase 17: exported colour {k}")
        check(np.allclose(np.loadtxt(os.path.join(out, "pose",
                                                  f"{k}.txt")),
                          frames[k][0], atol=1e-6),
              f"phase 17: exported pose {k}")
    print(f"phase 17: process_scene exported {len(kept)} frames in "
          f"{export_s:.2f} s ({1e3 * export_s / len(kept):.1f} ms a "
          f"frame); split {len(train_ids)} train / {len(test_ids)} "
          "test", flush=True)

    # ---- the loader on the export, its depth PNGs as priors
    ds = ScannetDataset(out, split="train", raw_scan_rootdir=raw,
                        depth_dir=os.path.join(out, "depth"),
                        device="cpu")
    want = np.stack([frames[k][2].reshape(-1) for k in train_ids]
                    ).astype(np.float64) / 1000.0 / (2 * ds.scale)
    prior_err = float(np.abs(np.asarray(ds.depths, np.float64)
                             - want).max())
    check(np.allclose(ds.depths, want, rtol=1e-5, atol=0),
          f"phase 17: priors off by {prior_err} in scene units")
    summary.update(frames=n, write_s=write_s, decode=decode,
                   export_s=export_s,
                   export_ms_per_frame=1e3 * export_s / len(kept),
                   split=dict(train=train_ids, test=test_ids),
                   prior_max_err_scene=prior_err)
    return frames, out, train_ids, test_ids, summary


def phase17(seed, scan, steps=SENS_STEPS):
    """The first stage of the ScanNet chain, scannet_tools, at ScanNet's
    native sizes, then the chain's training on what it exports:

      * write_scan_sens: phase 13's frames into a .sens;
      * SensorData: the header against what was written; every depth
        frame through the native batch decoder (csrc/sens_decode.cpp)
        against Python's zlib and against the array written; every
        colour frame decoded; decode ms a frame;
      * process_scene at 640x480 with frame skip SENS_FRAME_SKIP, then
        split_train_test (test step SENS_TEST_STEP): the exported depth
        PNGs equal to the frames' arrays, the poses to the files';
      * ScannetDataset over the exported tree with its depth/ PNGs as
        the priors (depth_dir): each prior the exported mm / 1000 in
        scene units (rtol 1e-5);
      * train_scannet_torch.run at opt.py's defaults with those priors
        (--depth_loss_w 0.1) for `steps` steps, a cli_leg run with the
        P2/P3 counters at 0 just before (read just after): both
        launched, the logged losses (one every 100 steps) finite, the
        depth term positive, validate PSNR >= 25 dB; the test views'
        depth MAE against the exported depth;
      * one step from the trained state with the kernels against the
        plain step (phase 9's bounds, P3_SUM_C);
      * P2/P3 on the last training step's calls on the kernels line
        (request "sens chain").

    Returns (summary, kernels-line entries)."""
    import os
    import tempfile

    from google_nerf_tpu_torch.data.base import directions_of
    t_phase = time.time()
    summary = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        frames, out, train_ids, test_ids, info = sens_export(tmp, scan)
        summary.update(info)
        # the test views' ray depth from the exported depth (mm of z)
        norm = np.linalg.norm(directions_of(480, 640, np.float32(SCANNET_K)),
                              axis=-1)
        gt = np.stack([frames[k][2].reshape(-1) / 1000.0 * norm
                       for k in test_ids])

        # ---- training on the export
        os.chdir(tmp)
        try:
            train, _, entries = cli_leg(
                "phase 17", "sens", [
                    "--root_dir", out, "--dataset_name", "scannet",
                    "--raw_scan_rootdir", scan[1], "--depth_dir",
                    os.path.join(out, "depth"), "--depth_loss_w", "0.1",
                    "--num_epochs", "1", "--steps_per_epoch", str(steps),
                    "--seed", str(seed), "--exp_name", "sens"],
                request="sens chain", depth=(gt, gt > 0),
                step=(seed + 17, None))
        finally:
            os.chdir(cwd)
    summary.update(train_keys(train), depth_mae_m=train["depth_mae_m"],
                   depth_loss=train["depth_loss"],
                   seconds=time.time() - t_phase)
    print(f"phase 17: {steps} steps in {train['wall_s']:.1f} s; "
          f"{train.get('ms_per_step')} ms/step; validate psnr "
          f"{train['psnr']:.3f}, ssim {train['ssim']:.4f}; test-view depth "
          f"MAE {train['depth_mae_m']:.4f} m; peak {train['peak_gib']:.2f} "
          f"GiB; launches {train['launches']}; kernel step vs plain step "
          f"{train['kernel_vs_plain_step']}; phase "
          f"{summary['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return summary, entries


# ------------------------------ phase 18: the shape refiner, SPVCNN

SHAPE_FRAMES = 2                  # of phase 13's 1296x968 frames
SHAPE_REL = 1e-4                  # a head's logit, card vs CPU
SHAPE_REPS = 5                    # spvcnn_apply calls timed a cloud (card)


def refine_card_vs_cpu(depth, heads_cpu, heads_dev):
    """reconstruct3d_from_depth's refinement of a (H, W) depth map (focal,
    shift, focal), each head run on the CPU's voxelized cloud with its
    weights on the CPU (`heads_cpu`) and on the card (`heads_dev`), in
    exact_f32; the chain goes on with the CPU's logits.  Returns (per
    step: logits, the cloud's counts and active sites, ms), shift, focal.
    """
    from google_nerf_tpu_torch.depth import spvcnn
    from google_nerf_tpu_torch.utils.precision import exact_f32
    h, w = depth.shape
    u0, v0 = w / 2.0, h / 2.0
    dn = depth - depth.min() + 0.5
    dn = dn / np.percentile(dn, 98)
    focal = h // 2 / np.tan((60 / 2.0) * np.pi / 180)
    card = next(iter(heads_dev["shift"]["classifier"].values())).device

    def voxels_before_cut(d, size):
        mask = d > 1e-8
        u = np.arange(w)[None, :] - u0
        v = np.arange(h)[:, None] - v0
        pts = np.stack([d * u / focal, d * v / focal, d], -1)[mask]
        pc = np.round(pts / size)
        pc -= pc.min(0, keepdims=True)
        return int(mask.sum()), int(np.unique(
            (pc[:, 0] * spvcnn.CMAX + pc[:, 1]) * spvcnn.CMAX
            + pc[:, 2]).size)

    def timed(params, cloud, reps):
        t = []
        for _ in range(reps):
            t0 = time.time()
            out = float(spvcnn.spvcnn_apply(params, *cloud)[0])
            t.append(1e3 * (time.time() - t0))
        return out, t

    steps, shift = [], 0.0
    with exact_f32():
        for label, head in (("focal1", "focal"), ("shift", "shift"),
                            ("focal2", "focal")):
            d = dn - shift if label == "focal2" else dn
            if head == "focal":
                cloud, size = spvcnn.focal_cloud(d, focal, u0, v0), 0.005
            else:
                cloud, size = spvcnn.shift_cloud(d, focal, u0, v0), 0.01
            coords, _, valid = cloud
            points, voxels = voxels_before_cut(d, size)
            cpu, cpu_ms = timed(heads_cpu[head], cloud, 1)
            got, card_ms = timed(heads_dev[head], cloud,
                                 SHAPE_REPS if card.type == "cuda" else 1)
            err = abs(got - cpu)
            check(err <= SHAPE_REL * max(abs(cpu), 0.1),
                  f"phase 18: {label} logit card {got} vs CPU {cpu}")
            step = dict(
                label=label, logit_cpu=cpu, logit_card=got, abs_err=err,
                points=points, voxels_before_cut=voxels,
                voxels_kept=int(valid.sum()),
                sites_past_10_bits=int(((coords >= spvcnn.CMAX).any(1)
                                        & valid).sum()),
                active_sites=spvcnn.active_sites(coords, valid),
                card_ms=card_ms, cpu_ms=cpu_ms)
            steps.append(step)
            print(f"phase 18: {label}: {step}", flush=True)
            if head == "focal":
                focal = focal / max(cpu, 1e-3)
            else:
                shift = min(min(cpu, 0.7), 0.6)
    return steps, shift, float(focal)


def phase18(seed, scan):
    """The shape refiner: depth_shape_torch.main at its defaults (LeReS
    ResNeXt101-32x8d at crop 448, the SPVCNN heads at channel ratio 1;
    random weights from the CLI's seeds: no checkpoint is in the repo) on
    SHAPE_FRAMES of phase 13's 1296x968 JPEGs, on the card; then on the
    first frame the same refinement, voxelize then spvcnn_apply three
    times (focal, shift, focal), with the heads on the card and on the
    CPU, both inside utils/precision.exact_f32, each head on the same
    voxelized cloud (the CPU's chain; voxelize rounds, so a last-bit
    difference could move a point to another voxel).

    Checks: every printed shift and focal finite, each
    <name>-depth_shifted.png 968x1296 uint16, each PLY of 1296 x 968
    finite points; each of the three logits on the card within SHAPE_REL
    (relative, floor 1e-5) of the CPU's, and the shift and focal built
    from them.  Reported: the active sites per level of each cloud, the
    points the voxelizer kept, its voxels before and after the n_cap
    draw, the sites past 10 bits, ms per spvcnn_apply (card, CPU), the
    CLI's seconds a frame, peak memory.  The CLI's priors (depth_of, no
    gradient) run the decoder's 3x3 kernels (ops/cuda/conv3x3; their
    count set to 0 just before, above 0 after); the refinement runs no
    kernel of the repo's own: searchsorted, row gathers, index_add_ and
    f32 products."""
    import io
    import os
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    import depth_shape_torch
    from depth_test_torch import depth_of, read_rgb01
    from google_nerf_tpu_torch.depth import spvcnn
    from google_nerf_tpu_torch.depth.model import DepthModelConfig
    from google_nerf_tpu_torch.ops.cuda.conv3x3 import conv3x3
    from google_nerf_tpu_torch.utils.image import read_image
    dev = torch.device("cuda")
    t_phase = time.time()
    scene, _, _ = scan
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        imgs, out = os.path.join(tmp, "imgs"), os.path.join(tmp, "out")
        os.makedirs(imgs)
        names = sorted(os.listdir(os.path.join(scene, "rgb")),
                       key=lambda f: int(f[:-4]))[:SHAPE_FRAMES]
        for f in names:
            shutil.copy(os.path.join(scene, "rgb", f), imgs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        conv3x3.launches = 0
        t0 = time.time()
        with redirect_stdout(buf):
            depth_shape_torch.main(["--img_dir", imgs, "--out_dir", out])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        c3_launches = conv3x3.launches
        check(c3_launches > 0, "phase 18: the CLI's priors never ran the "
              "conv3x3 kernels")
        cli_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        printed = [l.split() for l in buf.getvalue().splitlines()
                   if "shift=" in l]
        shifts = [float(w[0].split("=")[1]) for w in printed]
        focals = [float(w[1].split("=")[1]) for w in printed]
        check(len(printed) == SHAPE_FRAMES and all(
            math.isfinite(v) for v in shifts + focals),
            f"phase 18: depth_shape_torch printed {printed}")
        for f in names:
            base = os.path.splitext(f)[0]
            png = read_image(os.path.join(out, base + "-depth_shifted.png"))
            check(png.dtype == np.uint16 and png.shape == (968, 1296),
                  f"phase 18: {base}-depth_shifted.png {png.dtype} "
                  f"{png.shape}")
            with open(os.path.join(out, base + "-pcd.ply"), "rb") as fh:
                data = fh.read()
            body = data[data.index(b"end_header\n") + 11:]
            xyz = np.frombuffer(body, dtype=[("xyz", "<f4", 3),
                                             ("rgb", "u1", 3)])["xyz"]
            check(xyz.shape == (1296 * 968, 3) and np.isfinite(xyz).all(),
                  f"phase 18: {base}-pcd.ply holds {xyz.shape} points")
        print(f"phase 18: depth_shape_torch on {SHAPE_FRAMES} frames "
              f"(1296x968, crop 448) in {cli_s:.1f} s, peak {cli_peak:.2f} "
              f"GiB; shift {shifts}, focal {focals}; conv3x3 launches "
              f"{c3_launches}", flush=True)

        # ---- card vs CPU on frame 0, the CLI's heads
        cfg = DepthModelConfig(backbone=depth_shape_torch.BACKBONES[
            "resnext101"])
        model, shift_p, focal_p = depth_shape_torch.build_models(cfg, None,
                                                                 dev)
        heads_cpu = {k: spvcnn.params_to(p, "cpu")
                     for k, p in (("shift", shift_p), ("focal", focal_p))}
        heads_dev = {"shift": shift_p, "focal": focal_p}
        rgb01 = read_rgb01(os.path.join(imgs, names[0]))
        depth = depth_of(model, rgb01, 448, dev)
        del model
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, shift, focal = refine_card_vs_cpu(depth, heads_cpu, heads_dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    summary.update(cli_s=cli_s, cli_s_per_frame=cli_s / SHAPE_FRAMES,
                   cli_peak_gib=cli_peak, shifts=shifts, focals=focals,
                   refine=steps, shift=shift, focal=focal,
                   refine_peak_gib=peak, conv3x3_launches=c3_launches,
                   seconds=time.time() - t_phase)
    print(f"phase 18: frame 0 shift {summary['shift']:.4f}, focal "
          f"{summary['focal']:.1f}; spvcnn peak {peak:.2f} GiB; phase "
          f"{summary['seconds']:.1f} s", flush=True)
    return summary


DP_SIZES = dict(
    steps=16,                 # DP steps of the world of two on one card
    timed=10,                 # steps a turn in the world-of-one timing
    train_views=40, train_hw=256,     # phase 9's scene
    scene_views=8,            # views a multi-scene scene (at train_hw)
    bake_res=256,             # the brick renderer's bake (phase 10's)
    view=800,                 # the served frames
    syncbn_hw=64)
DP_SCENES = 2                 # multi-scene: procedural scenes, seeds 0, 1
DP_SYNCBN = dict(backbone="resnet18", per_rank=2)
DP_JOIN_S = 420               # the world of two's join timeout
DP_BRICK_TELEMETRY = ("trunc_tiles", "trunc_rays", "pairs_dropped",
                      "pairs_total")


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def dp_train_scene(dev, sizes):
    """Phase 9's scene (bench.py's: the textured scene, 40 views at
    256^2)."""
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    hw = sizes["train_hw"]
    return SyntheticDataset(split="train", n_images=sizes["train_views"],
                            img_wh=(hw, hw), style="textured",
                            device=dev).scene()


def dp_scene(seed, dev, sizes):
    """A multi-scene scene: the textured procedural scene from `seed`."""
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    hw = sizes["train_hw"]
    ds = SyntheticDataset(split="train", n_images=sizes["scene_views"],
                          img_wh=(hw, hw), style="textured", seed=seed,
                          device=dev)
    return ds, ds.scene()


def dp_scene_state(cfg, seed, dev, sizes):
    """Scene `seed`'s first state: init from seed, a warmup grid update on
    a generator from seed (the same in every process)."""
    from google_nerf_tpu_torch.train import system as tsys
    ds, scene = dp_scene(seed, dev, sizes)
    st = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                               generator=torch.Generator().manual_seed(seed),
                               device=dev)
    tsys.grid_update_step(st, cfg, warmup=True, generator=torch.Generator(
        device=dev).manual_seed(seed))
    return st, scene


def dp_serving(tree, cfg, dev, sizes):
    """The trained state's three serving inputs: the one-shot renderer's
    block2 tables, the fast renderer's seg words, the bake and its
    geometry; with the served view."""
    from google_nerf_tpu_torch.convert import train_state_from_jax
    from google_nerf_tpu_torch.models.baked import BakedConfig, bake
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
    import train_torch
    st = train_state_from_jax(tree, cfg, dev)
    m = cfg.model
    os_kw = bench_torch.SETTINGS["oneshot"]
    bcfg = BakedConfig(voxel_res=sizes["bake_res"], block=8,
                       dtype="bfloat16")
    baked = bake(st["params"], m, st["occ"], bcfg, device=dev)
    return dict(
        params=st["params"],
        view=bench_torch.serving_view(dev, sizes["view"], sizes["view"]),
        block2=pack_occupancy_block2(st["occ"],
                                     max_samples=os_kw["max_samples"],
                                     scale=m.scale),
        words=train_torch.serving_words(st, cfg), baked=baked, bcfg=bcfg,
        geo=brick_geometry(baked["block_map"], bcfg, m, dev))


def dp_frames(sv, cfg, dev, dp_forms: bool):
    """The three frames of the serving inputs: one-shot (bench.py's
    settings), fast (test.py's max_samples, chunks of a quarter of the
    frame) and brick (bench.py's); through
    the DP renderers or the serial ones.  The fast renderer's budget
    packing lets the rays that share a bucket move each other's window
    splits (5.3e-3 apart a pixel at 800^2 with its default chunk), so
    its chunk divides a rank's shard: the DP frame's chunks are then the
    serial frame's."""
    from google_nerf_tpu_torch.models.render_brick import render_brick
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    from google_nerf_tpu_torch.parallel import dp
    v, m = sv["view"], cfg.model
    oneshot = dp.render_test_oneshot_dp if dp_forms else render_test_oneshot
    fast = dp.render_test_fast_dp if dp_forms else render_test_fast
    brick = dp.render_brick_dp if dp_forms else render_brick
    out = dict(
        oneshot=oneshot(sv["params"], m, sv["block2"], v.rays_o, v.rays_d,
                        **bench_torch.SETTINGS["oneshot"]),
        fast=fast(sv["params"], m, sv["words"], v.rays_o, v.rays_d,
                  T_threshold=1e-2, max_samples=cfg.max_samples,
                  chunk=v.w * v.h // 4),
        brick=brick(sv["baked"], m, v.rays_o, v.rays_d, v.w, v.h,
                    bcfg=sv["bcfg"], geometry=sv["geo"], device=dev,
                    **bench_torch.SETTINGS["brick"]))
    sync(dev)
    return {k: {f: f_v for f, f_v in fr.items() if f in (
        "rgb", "opacity", "depth") + DP_BRICK_TELEMETRY}
        for k, fr in out.items()}


def dp_frame_errors(got, want, what):
    """rgb, opacity and depth within 1e-4 a pixel; the brick telemetry
    equal.  Returns the max abs differences."""
    errs = {}
    for k in ("rgb", "opacity", "depth"):
        g, w = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        errs[k] = float((g.to(w.device) - w).abs().max())
        check(errs[k] <= 1e-4, f"{what}: {k} max diff {errs[k]} > 1e-4")
    for k in DP_BRICK_TELEMETRY:
        if k in want:
            check(int(got[k]) == int(want[k]), f"{what}: {k} {int(got[k])} "
                  f"vs {int(want[k])}")
    return errs


def digest(t):
    import hashlib
    t = torch.as_tensor(t).detach().cpu().reshape(-1).contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def p2p3_counts(probe):
    return {"gather_rows_bf16": probe.gather_rows.launches["bfloat16"],
            "scatter_add_rows": probe.scatter_add_rows.launches}


def zero_p2p3(probe):
    probe.gather_rows.launches = {"float32": 0, "bfloat16": 0}
    probe.scatter_add_rows.launches = 0


def capture_grads(mod, run):
    """run() with mod.apply_grads wrapped to keep the gradients it is
    given; returns (run's result, the gradients)."""
    seen, apply = {}, mod.apply_grads

    def keep(state, grads, cfg):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return apply(state, grads, cfg)

    mod.apply_grads = keep
    try:
        return run(), seen
    finally:
        mod.apply_grads = apply


def grads_equal(got, want, table, what):
    """Every gradient but the table's within rtol 1e-6 (phase 9's
    bound)."""
    out = {}
    for k, w in want.items():
        if k == table:
            continue
        g = torch.as_tensor(got[k]).to(w.device)
        out[k] = float((g - w).abs().max())
        check(bool(((g - w).abs() <= 1e-6 * w.abs()).all()),
              f"{what}: gradient {k} beyond rtol 1e-6 (max abs {out[k]})")
    return out


def phase19_rank(tree, cfg, seed, step_draws, grid_draws_np, ms_draws,
                 bn_state, bn_rgb, dev, sizes):
    """One rank of phase 19's gloo world of two on one card: the DP
    steps (the params and Adam moments' digests, ms a step), one DP step
    on the parent's draws (its reduced gradients), the sharded grid
    update on the parent's draws, the three DP renderers at 800^2, this
    rank's scene of the multi-scene step (its metrics and gradients), and
    the SyncBN forwards; the P2/P3 launches of it all."""
    from google_nerf_tpu_torch.convert import train_state_from_jax
    from google_nerf_tpu_torch.depth.model import DepthModelConfig, DepthNet
    from google_nerf_tpu_torch.ops.cuda import probe
    from google_nerf_tpu_torch.parallel import comm, dp
    from google_nerf_tpu_torch.parallel.multiscene import \
        make_multiscene_train_step
    from google_nerf_tpu_torch.train import system as tsys
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = comm.get_rank()
    zero_p2p3(probe)
    scene = dp_train_scene(dev, sizes)
    n_steps = sizes["steps"]
    out = {}

    def tens(d):
        return {k: torch.as_tensor(v, device=dev) for k, v in d.items()}

    # the DP steps on the rank's own generator, timed after the first
    st = train_state_from_jax(tree, cfg, dev)
    step = dp.make_dp_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 100 + rank)
    step(st, scene, generator=gen)
    sync(dev)
    comm.synchronize()
    t0 = time.time()
    for _ in range(n_steps - 1):
        _, m = step(st, scene, generator=gen)
    sync(dev)
    out["step_ms"] = 1e3 * (time.time() - t0) / (n_steps - 1)
    check(math.isfinite(float(m["loss"])), "phase 19: a DP step's loss")
    out["allreduce_bytes"] = step.allreduce_bytes
    leaves = tsys.param_leaves(st["params"])
    out["digests"] = {k: digest(v) for k, v in leaves.items()}
    for k, v in leaves.items():
        for name, t in st["opt"].state[v].items():
            if torch.is_tensor(t):
                out["digests"][f"{k}/{name}"] = digest(t)

    # one DP step on the parent's per-rank draws: the reduced gradients
    _, out["reduced"] = capture_grads(dp, lambda: step(
        train_state_from_jax(tree, cfg, dev), scene,
        draws=tens(step_draws[rank])))

    # the sharded grid update on the parent's draws
    st = train_state_from_jax(tree, cfg, dev)
    dp.make_dp_grid_update(cfg)(st, warmup=False,
                                draws=[tens(d) for d in grid_draws_np])
    out["grid"] = {"density_grid": st["density_grid"], "occ": st["occ"],
                   **{f"occ_u8/{k}": v for k, v in st["occ_u8"].items()}}

    # the three DP renderers at 800^2 (rank 0 hands the frames back;
    # rank 1 their digests)
    sv = dp_serving(tree, cfg, dev, sizes)
    out["pool_digest"] = digest(sv["baked"]["pool"])
    frames = dp_frames(sv, cfg, dev, dp_forms=True)
    out["frames"] = frames if rank == 0 else {
        k: {f: digest(v) for f, v in fr.items()} for k, fr in frames.items()}
    del sv
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    # multi-scene: scene `rank`, one step on the parent's draws
    st, sc = dp_scene_state(cfg, rank, dev, sizes)
    (st, m), out["ms_grads"] = capture_grads(
        tsys, lambda: make_multiscene_train_step(cfg)(
            st, sc, draws=tens(ms_draws[rank])))
    out["ms_metrics"] = m

    # SyncBN: the rank's images, train mode, float32 and float64
    per = DP_SYNCBN["per_rank"]
    for dt in (torch.float32, torch.float64):
        model = DepthNet(DepthModelConfig(backbone=DP_SYNCBN["backbone"],
                                          bn_axis_name="data"))
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               bn_state.items()})
        model = model.to(dev, dt).train()
        with torch.no_grad():
            y = model(torch.as_tensor(bn_rgb[rank * per:(rank + 1) * per],
                                      device=dev, dtype=dt))
        key = str(dt).split(".")[1]
        out[f"bn_logit_{key}"] = y
        out[f"bn_stats_{key}"] = {k: v.clone() for k, v in
                                  model.state_dict().items()
                                  if "running" in k}
    sync(dev)
    out["launches"] = p2p3_counts(probe)
    return out


def phase19(seed, tree, cfg=None, dev="cuda:0", backend="nccl",
            sizes=DP_SIZES):
    """Data-parallel training and serving on the one card (phase19's
    notes in the module docstring): `backend` (NCCL) at a world of one in
    this process, then a gloo world of two spawned processes sharing the
    card.  `tree`: phase 9's trained state as numpy leaves; cfg: bench.py's
    training recipe unless given.  Returns (summary, kernels-line
    entries)."""
    import dataclasses

    import torch.distributed as dist

    from google_nerf_tpu_torch.convert import train_state_from_jax
    from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                                   DepthNet,
                                                   init_depth_model)
    from google_nerf_tpu_torch.ops import packed_hash as ph
    from google_nerf_tpu_torch.ops.cuda import probe
    from google_nerf_tpu_torch.ops.grid import grid_draws
    from google_nerf_tpu_torch.parallel import dp
    from google_nerf_tpu_torch.parallel.launch import free_port, run_world
    from google_nerf_tpu_torch.train import system as tsys
    t_phase = time.time()
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = cfg or bench_torch.train_config()
    m = cfg.model
    scene = dp_train_scene(dev, sizes)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    summary = {}

    # ---- NCCL at a world of one, in this process
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        check(dist.get_backend() == backend, f"phase 19: not {backend}")
        draws = draws_of(gen, scene, cfg, dev)
        batch = tsys.sample_batch(scene, cfg.batch_size,
                                  img_idxs=draws["img_idxs"],
                                  pix_idxs=draws["pix_idxs"])
        serial_state = train_state_from_jax(tree, cfg, dev)
        (ls, _, gs), kept = with_kept(
            ph, {"scatter_add_rows": dict(keep="last")},
            lambda: tsys.loss_and_grads(serial_state, scene, batch, cfg,
                                        draws=draws))
        gd = grid_draws(m.grid_size, m.cascades, warmup=False,
                        sample_div=cfg.grid_sample_div, generator=gen,
                        device=dev)
        grid_state = train_state_from_jax(tree, cfg, dev)
        serial_grid = tsys.grid_update_step(dict(grid_state), cfg,
                                            warmup=False, draws=gd)
        sv = dp_serving(tree, cfg, dev, sizes)
        serial_frames = dp_frames(sv, cfg, dev, dp_forms=False)

        # the DP path, its P2/P3 counts from 0
        dp_state = train_state_from_jax(tree, cfg, dev)
        step = dp.make_dp_train_step(cfg)
        zero_p2p3(probe)
        ((_, metrics), reduced), dp_kept = with_kept(
            ph, {"gather_rows": dict(keep="last"),
                 "scatter_add_rows": dict(keep="last")},
            lambda: capture_grads(dp, lambda: step(dp_state, scene,
                                                   draws=draws)))
        dp.make_dp_grid_update(cfg)(grid_state, warmup=False, draws=gd)
        frames = dp_frames(sv, cfg, dev, dp_forms=True)
        launches1 = p2p3_counts(probe)
        loss_rel = abs(float(metrics["loss"]) - float(ls)) / abs(float(ls))
        check(loss_rel <= 1e-6, f"phase 19: DP step loss "
              f"{float(metrics['loss'])} vs fused {float(ls)} at world 1")
        errs1 = dict(loss_rel=loss_rel, grads=grads_equal(
            reduced, gs, "packed_table", "phase 19 world 1"))
        sidx, vals, T = kept["scatter_add_rows"].calls[0][0]
        errs1["packed_table"] = table_vs_sum64(
            reduced["packed_table"], sidx, vals, T,
            "phase 19 world 1: DP table gradient vs the float64 sum")
        for k in ("density_grid", "occ"):
            check(torch.equal(grid_state[k], serial_grid[k]),
                  f"phase 19 world 1: sharded {k} != serial")
        for k, v in serial_grid["occ_u8"].items():
            check(torch.equal(grid_state["occ_u8"][k], v),
                  f"phase 19 world 1: sharded occ_u8/{k} != serial")
        errs1["frames"] = {k: dp_frame_errors(frames[k], serial_frames[k],
                                              f"phase 19 world 1 {k}")
                           for k in frames}

        # ms a step: the plain fused step and the DP step, in turns
        plain_state = train_state_from_jax(tree, cfg, dev)

        def turn(fn):
            sync(dev)
            t0 = time.time()
            for _ in range(sizes["timed"]):
                fn()
            sync(dev)
            return 1e3 * (time.time() - t0) / sizes["timed"]

        def plain():
            return tsys.fused_train_step(plain_state, scene, cfg,
                                         generator=gen)

        def dps():
            return step(dp_state, scene, generator=gen)
        turn(plain)
        turn(dps)                               # warm both
        ms = dict(plain=[turn(plain)], dp=[turn(dps), turn(dps)])
        ms["plain"].append(turn(plain))
        summary["world1"] = dict(
            errors=errs1, launches=launches1,
            step_ms=ms, allreduce_bytes=step.allreduce_bytes)
        print(f"phase 19: NCCL world of 1: DP step vs fused step {errs1}; "
              f"grid update bit for bit; frames {errs1['frames']}; ms a "
              f"step plain {ms['plain']}, DP {ms['dp']}; all-reduced "
              f"{step.allreduce_bytes} bytes a step; launches {launches1}",
              flush=True)
    finally:
        dist.destroy_process_group()
    del sv, serial_state, grid_state, dp_state, plain_state, frames
    if dev.type == "cuda":
        torch.cuda.empty_cache()        # the two ranks share the card

    # ---- a gloo world of two processes on the one card
    n = 2
    local = dataclasses.replace(cfg, batch_size=cfg.batch_size // n)
    step_draws = [{k: v.cpu().numpy() for k, v in
                   draws_of(gen, scene, local, dev).items()}
                  for _ in range(n)]
    grid_np = [{k: v.cpu().numpy() for k, v in d.items()} for d in gd]
    ms_draws = []
    for s in range(DP_SCENES):
        _, sc = dp_scene(s, dev, sizes)
        ms_draws.append({k: v.cpu().numpy() for k, v in
                         draws_of(gen, sc, cfg, dev).items()})
    hw = sizes["syncbn_hw"]
    bn_model = init_depth_model(torch.Generator().manual_seed(seed),
                                DepthModelConfig(
                                    backbone=DP_SYNCBN["backbone"]),
                                device="cpu")
    bn_state = {k: v.numpy() for k, v in bn_model.state_dict().items()}
    bn_rgb = np.random.default_rng(seed).uniform(
        size=(n * DP_SYNCBN["per_rank"], 3, hw, hw)).astype(np.float32)
    t0 = time.time()
    ranks = run_world(phase19_rank, n, (
        tree, cfg, seed, step_draws, grid_np, ms_draws, bn_state, bn_rgb,
        str(dev), sizes), backend="gloo", device=dev, timeout=DP_JOIN_S,
        threads=4)
    world_s = time.time() - t0
    r0, r1 = ranks
    check(r0["digests"] == r1["digests"], "phase 19 world 2: params or Adam "
          "moments differ across the ranks after the DP steps")

    # the reduced gradients against the serial mean of the shards'
    shard = []
    for r in range(n):
        d = {k: torch.as_tensor(v, device=dev)
             for k, v in step_draws[r].items()}
        b = tsys.sample_batch(scene, local.batch_size,
                              img_idxs=d["img_idxs"], pix_idxs=d["pix_idxs"])
        (l, _, g), kept = with_kept(
            ph, {"scatter_add_rows": dict(keep="last")},
            lambda: tsys.loss_and_grads(train_state_from_jax(tree, cfg, dev),
                                        scene, b, cfg, draws=d))
        shard.append((l, g, kept["scatter_add_rows"].calls[0][0]))
    mean = {k: (shard[0][1][k] + shard[1][1][k]) / 2 for k in shard[0][1]}
    errs2 = dict(grads=grads_equal(r0["reduced"], mean, "packed_table",
                                   "phase 19 world 2"))
    for rr in ranks:
        for k, v in rr["reduced"].items():
            check(np.array_equal(v, r0["reduced"][k]),
                  f"phase 19 world 2: reduced {k} differs across the ranks")
    (s0, v0, T), (s1, v1, _) = shard[0][2], shard[1][2]
    errs2["packed_table"] = table_vs_sum64(
        torch.as_tensor(r0["reduced"]["packed_table"], device=dev),
        torch.cat([s0, s1]), torch.cat([v0, v1]), T,
        "phase 19 world 2: reduced table gradient vs the float64 mean",
        scale=2.0)

    # the grid update bit for bit
    for k, v in r0["grid"].items():
        want = (serial_grid["occ_u8"][k.split("/")[1]] if "/" in k
                else serial_grid[k])
        check(np.array_equal(v, want.cpu().numpy()),
              f"phase 19 world 2: sharded {k} != serial")
        check(digest(v) == digest(r1["grid"][k]),
              f"phase 19 world 2: {k} differs across the ranks")

    # the three DP renderers against the serial frames
    check(r0["pool_digest"] == r1["pool_digest"] == digest(
        dp_serving(tree, cfg, dev, sizes)["baked"]["pool"]),
        "phase 19 world 2: the ranks' bakes differ from this process's")
    errs2["frames"] = {k: dp_frame_errors(r0["frames"][k], serial_frames[k],
                                          f"phase 19 world 2 {k}")
                       for k in serial_frames}
    for k, fr in r1["frames"].items():
        for f, dg in fr.items():
            check(dg == digest(r0["frames"][k][f]), f"phase 19 world 2: "
                  f"{k} {f} differs across the ranks")

    # multi-scene: each scene against a lone fused step on the same draws
    errs2["multiscene"] = {}
    for s in range(DP_SCENES):
        st, sc = dp_scene_state(cfg, s, dev, sizes)
        d = {k: torch.as_tensor(v, device=dev)
             for k, v in ms_draws[s].items()}
        b = tsys.sample_batch(sc, cfg.batch_size, img_idxs=d["img_idxs"],
                              pix_idxs=d["pix_idxs"])
        (l, _, g), kept = with_kept(
            ph, {"scatter_add_rows": dict(keep="last")},
            lambda: tsys.loss_and_grads(st, sc, b, cfg, draws=d))
        for rr in ranks:
            check(rr["ms_metrics"]["loss"].shape == (DP_SCENES,),
                  "phase 19: multi-scene metrics are not per scene")
        got = ranks[s]
        lrel = abs(float(got["ms_metrics"]["loss"][s]) - float(l)) / abs(
            float(l))
        check(lrel <= 1e-6, f"phase 19: multi-scene loss of scene {s}")
        e = dict(loss_rel=lrel, grads=grads_equal(
            got["ms_grads"], g, "packed_table", f"phase 19 scene {s}"))
        sidx, vals, T = kept["scatter_add_rows"].calls[0][0]
        e["packed_table"] = table_vs_sum64(
            torch.as_tensor(got["ms_grads"]["packed_table"], device=dev),
            sidx, vals, T, f"phase 19: scene {s} table gradient vs the "
            "float64 sum")
        errs2["multiscene"][s] = e

    # SyncBN: the sharded train-mode forward against the unsharded one
    errs2["syncbn"] = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        model = DepthNet(DepthModelConfig(backbone=DP_SYNCBN["backbone"]))
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in bn_state.items()})
        model = model.to(dev, dt).train()
        with torch.no_grad():
            y = model(torch.as_tensor(bn_rgb, device=dev, dtype=dt))
        key = str(dt).split(".")[1]
        got = torch.as_tensor(np.concatenate(
            [rr[f"bn_logit_{key}"] for rr in ranks]), device=dev, dtype=dt)
        rel = float((got - y).norm() / y.norm())
        check(rel <= tol, f"phase 19: SyncBN {key} forward {rel} > {tol}")
        srel = 0.0
        for k, v in model.state_dict().items():
            if "running" in k:
                g = torch.as_tensor(r0[f"bn_stats_{key}"][k], device=dev,
                                    dtype=dt)
                srel = max(srel, float((g - v).norm() / v.norm()))
        check(srel <= tol, f"phase 19: SyncBN {key} running statistics "
              f"{srel} > {tol}")
        errs2["syncbn"][key] = dict(logit=rel, running=srel)

    launches = {k: launches1[k] + r0["launches"][k] + r1["launches"][k]
                for k in launches1}
    summary["world2"] = dict(
        errors=errs2, step_ms=[r0["step_ms"], r1["step_ms"]],
        allreduce_bytes=r0["allreduce_bytes"], world_s=world_s,
        launches=[r0["launches"], r1["launches"]])
    print(f"phase 19: gloo world of 2 on one card ({world_s:.1f} s): "
          f"params and Adam moments equal across the ranks after "
          f"{sizes['steps']} steps; {r0['step_ms']:.3f} / "
          f"{r1['step_ms']:.3f} ms "
          "a step (two ranks sharing one card: not a scaling figure); "
          f"all-reduced {r0['allreduce_bytes']} bytes a step; {errs2}; "
          f"launches {r0['launches']}, {r1['launches']}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"phase 19: {k} not launched on the DP path")
    entries = probe_entries(probe, dp_kept, launches, "dp", "phase 19")
    summary["launches"] = launches
    summary["seconds"] = time.time() - t_phase
    return summary, entries


# ------------------------- phase 20: an RTMV scene of OpenEXR frames

RTMV_VIEWS = 110      # the fewest with a test view under the 100/5/45
                      # split (test starts at 105); RTMV: 150 a scene
RTMV_WH = 1600        # RTMV's frames are 1600x1600
RTMV_FOCAL = 1600.0   # pixels: a 53-degree field of view, as phase 13's
RTMV_RADIUS = 2.0     # the cameras' distance: the object fills the middle
                      # third of a frame
RTMV_SHIFT = (0.1, -0.2, 0.3)   # the scene box's centre in the files'
                                # frame (the bricks subset's rescale)
RTMV_MARCH = 0.4      # half-side of the cube the integrator marches: the
                      # objects, displaced, lie within 0.352 of the centre
                      # (26% of the rays enter it; 43% the 0.5 box)


def render_box_hits(dirs, pose, dev):
    """render_views' integrator (the textured scene, 512 steps) over the
    cube of half-side RTMV_MARCH, on the rays of one pose that enter it,
    in chunks; the others are empty, as the integrator makes them (no
    weight).  -> (HW, 4) premultiplied rgb + alpha as numpy."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import _integrate_gt
    from google_nerf_tpu_torch.ops.ray_aabb import (clamp_near,
                                                    ray_aabb_intersect)
    o, d = get_rays(dirs, torch.as_tensor(pose, device=dev))
    hits = clamp_near(ray_aabb_intersect(
        o, d / torch.linalg.norm(d, dim=-1, keepdim=True), torch.zeros(3),
        torch.full((3,), RTMV_MARCH)), 0.05)
    idx = torch.nonzero(hits[:, 0] >= 0)[:, 0]
    out = torch.zeros(o.shape[0], 4, device=dev)
    chunk = 1 << 17      # (chunk, 512, 4-object) intermediates ~4 GB
    for i in range(0, idx.numel(), chunk):
        j = idx[i:i + chunk]
        out[j] = _integrate_gt(o[j], d[j], scale=RTMV_MARCH,
                               style="textured")
    return out.cpu().numpy()


class PeakRss:
    """The process's peak resident memory while the `with` block runs,
    sampled from /proc/self/statm every 50 ms (GiB)."""

    def __enter__(self):
        import os
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak, self.stop = self.rss(), threading.Event()
        self.thread = threading.Thread(target=self.sample, daemon=True)
        self.thread.start()
        return self

    def rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page / 2 ** 30

    def sample(self):
        while not self.stop.wait(0.05):
            self.peak = max(self.peak, self.rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=5)
        self.peak = max(self.peak, self.rss())


def write_rtmv_scene(root, seed, dev):
    """An RTMV-layout scene of the textured procedural scene (the bricks
    subset's layout): <i>.json camera_data (cam2world in OpenGL axes,
    stored transposed, the intrinsics, the scene's 3-D box) and
    images/<i>.exr, ZIP-compressed HALF RGBA of straight colour with
    alpha the integrator's opacity, as phase 13's PNGs (render_box_hits).
    Cameras at RTMV_RADIUS on a Fibonacci sphere, shuffled from `seed`
    so the test views sit among the train views.  The box is the cube of
    half-side 0.5 / 1.05 about RTMV_SHIFT, so the loader's rescale,
    (t - centre) / (2 x 0.5), maps the files' poses onto the scene's.
    Rendering on the card overlaps the host's work on the frame before
    (one writer thread: straight colour, HALF, then the file, its chunks
    compressed on 8 threads).  Returns (the HALF frames written, by path;
    render seconds; the writer thread's seconds)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from google_nerf_tpu_torch.data.base import directions_of
    from google_nerf_tpu_torch.data.synthetic import _fibonacci_poses
    from google_nerf_tpu_torch.tools.exr_fixture import write_exr
    os.makedirs(os.path.join(root, "images"))
    views, wh = RTMV_VIEWS, RTMV_WH
    K = np.float32([[RTMV_FOCAL, 0, wh / 2], [0, RTMV_FOCAL, wh / 2],
                    [0, 0, 1]])
    dirs = torch.as_tensor(directions_of(wh, wh, K), device=dev)
    poses = _fibonacci_poses(views, RTMV_RADIUS, seed)[
        np.random.RandomState(seed).permutation(views)]
    shift = np.asarray(RTMV_SHIFT)
    r = 0.5 / 1.05
    box = dict(scene_center_3d_box=shift.tolist(),
               scene_min_3d_box=(shift - r).tolist(),
               scene_max_3d_box=(shift + r).tolist())
    write_s = [0.0]

    def write(path, rgba):
        t0 = time.time()
        a = np.clip(rgba[:, 3], 0.0, 1.0)
        rgb = np.where(a[:, None] > 1 / 510, rgba[:, :3]
                       / np.maximum(a[:, None], 1e-6), 0.0)
        img = np.clip(np.concatenate([rgb, a[:, None]], -1), 0.0, 1.0
                      ).reshape(wh, wh, 4).astype(np.float16)
        write_exr(path, img, compression="ZIP", pixel_type="HALF")
        write_s[0] += time.time() - t0
        return img

    render_s = 0.0
    with ThreadPoolExecutor(max_workers=1) as writer:
        pending = []
        for i in range(views):
            t0 = time.time()
            rgba = render_box_hits(dirs, poses[i], dev)
            render_s += time.time() - t0
            path = os.path.join(root, "images", f"{i:05d}.exr")
            pending.append((path, writer.submit(write, path, rgba)))
            gl = _homog(poses[i]).astype(np.float64)
            gl[:3, 3] += shift
            gl[:3, 1:3] *= -1                          # rdf -> OpenGL
            cam = dict(cam2world=gl.T.tolist(), width=wh, height=wh,
                       intrinsics=dict(fx=RTMV_FOCAL, fy=RTMV_FOCAL,
                                       cx=wh / 2, cy=wh / 2), **box)
            with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
                json.dump(dict(camera_data=cam), f)
        written = {path: job.result() for path, job in pending}
    return written, render_s, write_s[0]


def decode_rtmv_frames(written):
    """Every frame read back (8 threads) against the HALF samples
    written, bit for bit; then one frame's decode timed (median of 3).
    Returns (frames that differ, decode ms a frame)."""
    from concurrent.futures import ThreadPoolExecutor

    from google_nerf_tpu_torch.utils.image import read_image

    def same(path):
        got = read_image(path)
        want = written[path].astype(np.float32)
        return got.shape == want.shape and np.array_equal(
            got.view(np.uint32), want.view(np.uint32))

    with ThreadPoolExecutor(max_workers=8) as pool:
        bad = [p for p, ok in zip(written, pool.map(same, written))
               if not ok]
    first = next(iter(written))
    times = []
    for _ in range(3):
        t0 = time.time()
        read_image(first)
        times.append(1e3 * (time.time() - t0))
    return bad, statistics.median(times)


def phase20(seed, steps=DATA_STEPS):
    """RTMV from OpenEXR frames through the CLIs, in a temporary
    directory: write_rtmv_scene (RTMV_VIEWS views at RTMV_WH^2, cut in
    depth only: RTMV has 150 a scene); every frame decoded back bit for
    bit; train_torch.main --dataset_name rtmv at opt.py's defaults (full
    width, --downsample 1.0) for `steps` steps with the kernel counters
    at 0 just before (read just after); validate; test_torch.run's
    default renderer on the slim checkpoint; one step from the trained
    state on a batch of the test views with the kernels against the
    plain step (phase 9's bounds, P3_SUM_C).  Checks: the decode exact; the logged losses finite;
    validate PSNR >= 25 dB; P2 and P3 launched in training and P2 in
    serving; test_torch's PSNR within 1 dB of validate's.  P2/P3 of the
    last training step join the kernels line (request "rtmv").  Reports
    the phase's seconds, the writer's share, the EXR decode ms of one
    frame, ms a step, rays/s, and the peak host and device memory.
    Returns (summary, kernels-line entries)."""
    import os
    import tempfile
    dev = torch.device("cuda")
    t_phase = time.time()
    cut = (f"depth cut: {RTMV_VIEWS} views at {RTMV_WH}^2 (RTMV: 150), 1 "
           f"epoch of {steps} steps (opt.py: 30 x 1000); widths at opt.py's "
           "defaults")
    print(f"phase 20: {cut}", flush=True)
    summary = dict(cut=cut)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, PeakRss() as rss:
        os.chdir(tmp)
        try:
            root = os.path.join(tmp, "data", "rtmv", "bricks", "procedural")
            t0 = time.time()
            written, render_s, write_s = write_rtmv_scene(root, seed, dev)
            scene_s = time.time() - t0
            bad, decode_ms = decode_rtmv_frames(written)
            frames = len(written)
            del written
            check(not bad, f"phase 20: {len(bad)} EXR frames decoded "
                  f"otherwise than written: {bad[:3]}")
            summary.update(frames=frames, scene_s=scene_s, render_s=render_s,
                           write_s=write_s, exr_decode_ms=decode_ms)
            print(f"phase 20: {frames} EXR frames written in {scene_s:.1f} s "
                  f"(render {render_s:.1f} s on the card, writer thread "
                  f"{write_s:.1f} s beside it), each decoded back bit "
                  f"for bit; decode of one {RTMV_WH}^2 frame {decode_ms:.1f} "
                  "ms", flush=True)

            # the step draws its batch from the 5 test views: the 3.1 GB
            # of train rays are not loaded again
            train, served, entries = cli_leg(
                "phase 20", "rtmv", [
                    "--root_dir", root, "--dataset_name", "rtmv",
                    "--exp_name", "rtmv", "--num_epochs", "1",
                    "--steps_per_epoch", str(steps), "--seed", str(seed)],
                request="rtmv", serve=(Serve("rtmv", gap=1.0),),
                step=(seed + 20, "test"))
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    summary.update(train_keys(train), peak_host_gib=rss.peak,
                   serve=served["rtmv"], seconds=time.time() - t_phase)
    summary["writer_share"] = summary["scene_s"] / summary["seconds"]
    print(f"phase 20: phase {summary['seconds']:.1f} s, the scene's writing "
          f"{summary['scene_s']:.1f} s of it "
          f"({100 * summary['writer_share']:.1f}%); peak host memory "
          f"{rss.peak:.2f} GiB (the process), card {train['peak_gib']:.2f} "
          "GiB", flush=True)
    return summary, entries


# ------------------ phase 21: a COLMAP scene of JPEG frames in every mode

COLMAP_VIEWS = 24          # LLFF's scenes hold 20-62 views
COLMAP_WH = (1008, 756)    # LLFF's images_4: a 4032x3024 frame quartered
COLMAP_FOCAL = 815.0       # pixels at images_4 (LLFF's fern: 815.1)
COLMAP_RADIUS = 1.2        # phase 13's cameras: the object fills a third
COLMAP_QUALITY = 95
COLMAP_POINTS = 4096       # surface points in points3D.bin
COLMAP_DEPTH_STRIDE = 8    # every 8th pixel a way gives the surface points
COLMAP_STEPS = 192         # a depth cut (DATA_STEPS: 512) to keep the phase
                           # near 45 s: the COLMAP step takes the dense
                           # exp-step marcher, 48-60 ms
COLMAP_MIN_PSNR = 30.0     # a DCT frame against the pixels written: a
                           # picture of the scene, not noise (the exact
                           # checks are the twins and the lossless frames)
COLMAP_MODES = (           # taken in turn, frame by frame
    ("huffman 4:4:0", dict(sampling=((1, 2), (1, 1), (1, 1)))),
    ("arithmetic 4:2:0", dict(sampling=((2, 2), (1, 1), (1, 1)),
                              coding="arithmetic",
                              restart=-(-COLMAP_WH[0] // 16))),
    ("arithmetic progressive 4:2:0", dict(sampling=((2, 2), (1, 1), (1, 1)),
                                          coding="arithmetic",
                                          progressive=True)),
    ("lossless", dict(colour="rgb", coding="lossless", jfif=False,
                      predictor=1)))


def surface_points(dirs, pose, w, dev, stride=COLMAP_DEPTH_STRIDE):
    """Points on the textured scene's surface seen from `pose` (dirs: a
    frame `w` wide): the integrator's expected distance along every
    `stride`-th ray a way that ends opaque (alpha > 0.99), over
    RTMV_MARCH's cube.  -> (n, 3) positions and their (n, 3) uint8
    colours."""
    from google_nerf_tpu_torch.core.rays import get_rays
    from google_nerf_tpu_torch.data.synthetic import _integrate_gt
    keep = torch.arange(dirs.shape[0], device=dev).reshape(-1, w)[
        ::stride, ::stride].reshape(-1)
    o, d = get_rays(dirs[keep], torch.as_tensor(pose, device=dev))
    out = _integrate_gt(o, d, scale=RTMV_MARCH, style="textured",
                        with_depth=True)
    hit = out[:, 3] > 0.99
    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    xyz = o[hit] + dn[hit] * out[hit, 4:5]
    rgb = (out[hit, :3].clamp(0, 1) * 255 + 0.5).to(torch.uint8)
    return xyz.cpu().numpy().astype(np.float64), rgb.cpu().numpy()


def write_colmap_scene(root, seed, dev, views=COLMAP_VIEWS, wh=COLMAP_WH,
                       focal=COLMAP_FOCAL):
    """A COLMAP scene of the textured procedural scene, as a phone
    capture reaches the trainer: images/<i>.jpg at wh (LLFF's images_4),
    the integrator's premultiplied colour (a black background: the
    trainer's for COLMAP's unbounded scenes, models/rendering.py
    _background), each frame in one of COLMAP_MODES
    taken in turn (tools/jpeg_fixture.py, quality COLMAP_QUALITY), and
    sparse/0's cameras.bin (one PINHOLE camera), images.bin (OpenCV
    world-to-camera poses) and points3D.bin (COLMAP_POINTS points on the
    object's surface, from the integrator's depth;
    tools/colmap_fixture.py).  Cameras at COLMAP_RADIUS on phase 13's
    Fibonacci band, looking at the object.  One writer thread encodes a
    frame while the card renders the next.  Returns ({path: (mode, the
    frame's coefficients and samples, the pixels written)}, render
    seconds, the writer thread's seconds)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from google_nerf_tpu_torch.data.base import directions_of
    from google_nerf_tpu_torch.data.synthetic import _fibonacci_poses
    from google_nerf_tpu_torch.tools.colmap_fixture import w2c_of, write_model
    from google_nerf_tpu_torch.tools.jpeg_fixture import Frame, encode
    os.makedirs(os.path.join(root, "images"))
    w, h = wh
    K = np.float32([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    dirs = torch.as_tensor(directions_of(h, w, K), device=dev)
    poses = _fibonacci_poses(views, COLMAP_RADIUS, seed)
    rng = np.random.RandomState(seed)
    images, xyz, rgb = [], [], []
    render_s, write_s = 0.0, [0.0]

    def write(path, rgba, mode, kw):
        t0 = time.time()
        img = (np.clip(rgba[:, :3], 0.0, 1.0) * 255 + 0.5).astype(
            np.uint8).reshape(h, w, 3)
        kw = dict(kw)
        frame = Frame(img, COLMAP_QUALITY, kw.pop("sampling", None),
                      kw.pop("colour", None))
        with open(path, "wb") as f:
            f.write(encode(frame, **kw))
        write_s[0] += time.time() - t0
        return mode, frame, img

    # one writer thread encodes a frame while the card renders the next
    with ThreadPoolExecutor(max_workers=1) as writer:
        pending = []
        for i in range(views):
            t0 = time.time()
            rgba = render_box_hits(dirs, poses[i], dev)
            p, c = surface_points(dirs, poses[i], w, dev)
            render_s += time.time() - t0
            name = f"{i:04d}.jpg"
            path = os.path.join(root, "images", name)
            pending.append((path, writer.submit(
                write, path, rgba, *COLMAP_MODES[i % len(COLMAP_MODES)])))
            images.append((i + 1, *w2c_of(poses[i]), 1, name, []))
            xyz.append(p)
            rgb.append(c)
        written = {path: job.result() for path, job in pending}
    xyz, rgb = np.concatenate(xyz), np.concatenate(rgb)
    pick = rng.choice(len(xyz), min(COLMAP_POINTS, len(xyz)), replace=False)
    write_model(os.path.join(root, "sparse", "0"),
                [(1, 1, w, h, (focal, focal, w / 2, h / 2))], images,
                [(k + 1, xyz[j], rgb[j], 0.5, [])
                 for k, j in enumerate(pick)])
    return written, render_s, write_s[0]


def check_colmap_frames(written):
    """Every frame decoded (8 threads): each arithmetic frame bit for bit
    to its Huffman twin (the same coefficients, written sequential
    Huffman in memory), each lossless frame to the pixels written, each
    DCT frame within COLMAP_MIN_PSNR of them; then one frame of each
    mode's decode timed (median of 3).  Returns (frames that failed,
    {mode: decode ms}, {mode: lowest PSNR})."""
    from concurrent.futures import ThreadPoolExecutor

    from google_nerf_tpu_torch.tools.jpeg_fixture import encode
    from google_nerf_tpu_torch.utils.image import decode_jpeg, read_image

    def one(path):
        mode, frame, img = written[path]
        got = read_image(path)
        if got.shape != img.shape:
            return False, None
        if mode == "lossless":
            return bool(np.array_equal(got, img)), None
        ok = True
        if mode.startswith("arithmetic"):
            ok = bool(np.array_equal(got, decode_jpeg(encode(frame))))
        mse = np.mean((got.astype(np.float64) - img) ** 2)
        psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
        return ok and psnr >= COLMAP_MIN_PSNR, psnr

    with ThreadPoolExecutor(max_workers=8) as pool:
        res = dict(zip(written, pool.map(one, written)))
    bad = [p for p, (ok, _) in res.items() if not ok]
    psnr, decode_ms = {}, {}
    for path, (mode, _, _) in written.items():
        if res[path][1] is not None:
            psnr[mode] = min(psnr.get(mode, math.inf), res[path][1])
        if mode in decode_ms:
            continue
        times = []
        for _ in range(3):
            t0 = time.time()
            read_image(path)
            times.append(1e3 * (time.time() - t0))
        decode_ms[mode] = statistics.median(times)
    return bad, decode_ms, psnr


def phase21(seed, steps=COLMAP_STEPS):
    """COLMAP from JPEG frames of every mode through the CLIs, in a
    temporary directory: write_colmap_scene (COLMAP_VIEWS views at
    COLMAP_WH, cut in depth only); check_colmap_frames; train_torch.main
    --dataset_name colmap at opt.py's defaults (full width, --downsample
    1.0) for `steps` steps with the kernel counters at 0 just before
    (read just after); validate; test_torch.run's default renderer on
    the slim checkpoint; one step from the trained state on a batch of
    the test views with the kernels against the plain step (phase 9's
    bounds, P3_SUM_C).  Checks: the frames as check_colmap_frames says;
    the logged losses finite; validate PSNR >= 25 dB; P2 and P3 launched
    in training and P2 in serving; test_torch's PSNR within 1 dB of
    validate's.  P2/P3 of the last training step join the kernels line
    (request "colmap").  Reports the phase's seconds, the writer's
    seconds, decode ms a frame of each mode, ms a step, rays/s, and the
    peak host and device memory.  Returns (summary, kernels-line
    entries)."""
    import os
    import tempfile
    dev = torch.device("cuda")
    t_phase = time.time()
    cut = (f"depth cut: {COLMAP_VIEWS} views at {COLMAP_WH[0]}x"
           f"{COLMAP_WH[1]} (LLFF's images_4; LLFF: 20-62 views), 1 epoch "
           f"of {steps} steps (opt.py: 30 x 1000); widths at opt.py's "
           "defaults")
    print(f"phase 21: {cut}", flush=True)
    summary = dict(cut=cut)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, PeakRss() as rss:
        os.chdir(tmp)
        try:
            root = os.path.join(tmp, "data", "colmap", "procedural")
            t0 = time.time()
            written, render_s, write_s = write_colmap_scene(root, seed, dev)
            scene_s = time.time() - t0
            bad, decode_ms, psnr = check_colmap_frames(written)
            frames = len(written)
            del written
            check(not bad, f"phase 21: {len(bad)} JPEG frames failed their "
                  f"decode checks: {bad[:3]}")
            summary.update(frames=frames, scene_s=scene_s, render_s=render_s,
                           write_s=write_s, decode_ms=decode_ms,
                           dct_psnr_min=psnr)
            print(f"phase 21: {frames} JPEG frames ("
                  + ", ".join(m for m, _ in COLMAP_MODES)
                  + f" in turn) written in {scene_s:.1f} s (render "
                  f"{render_s:.1f} s on the card, the writer {write_s:.1f}"
                  " s); arithmetic frames equal their Huffman twins, "
                  "lossless frames the pixels; lowest PSNR of the DCT "
                  f"frames {psnr}; decode ms a frame {decode_ms}",
                  flush=True)

            train, served, entries = cli_leg(
                "phase 21", "colmap", [
                    "--root_dir", root, "--dataset_name", "colmap",
                    "--exp_name", "colmap", "--downsample", "1.0",
                    "--num_epochs", "1", "--steps_per_epoch", str(steps),
                    "--seed", str(seed)],
                request="colmap", serve=(Serve("colmap", gap=1.0),),
                step=(seed + 21, "test"))
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    summary.update(train_keys(train), peak_host_gib=rss.peak,
                   serve=served["colmap"], seconds=time.time() - t_phase)
    print(f"phase 21: phase {summary['seconds']:.1f} s, the scene's writing "
          f"{summary['scene_s']:.1f} s of it; peak host memory "
          f"{rss.peak:.2f} GiB (the process), card {train['peak_gib']:.2f} "
          "GiB", flush=True)
    return summary, entries

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
    from google_nerf_tpu_torch.models.ngp import init_ngp
    from google_nerf_tpu_torch.convert import train_state_to_numpy
    from google_nerf_tpu_torch.models.render_brick import brick_geometry
    from google_nerf_tpu_torch.ops.cuda import _build
    from google_nerf_tpu_torch.ops.cuda import brick_field as bf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    started = {}        # phase -> seconds since the start, where it began

    def begin(phase):
        started[phase] = round(time.time() - t_start, 1)
        print(f"phase {phase} begins at {started[phase]} s", flush=True)

    begin(1)
    # ---- 1: card and build
    card = card_line()
    print(card, flush=True)            # name, power limit as nvidia-smi says

    t0 = time.time()
    libs = _build.build("brick_field_dense", "probe", "ladder",
                        "image_codec", "jpeg_fixture",
                        "sens_decode")  # nvcc, cc, g++ at once
    build_s = time.time() - t0
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        print(f"phase 1: built {lib.name} in {build_s:.1f} s; "
              + "; ".join(l.split("info    : ")[-1] for l in log.splitlines()
                          if "registers" in l or "spill" in l), flush=True)

    begin(2)
    # ---- 2: kernels against plain versions at serving widths
    errs2 = phase2(bf, args.seed, dev)
    print(f"phase 2: kernels vs plain and golden at serving widths, max abs "
          f"err {errs2}", flush=True)

    begin(3)
    # ---- 3: the wl256 request at full width
    cfg = bench_torch.model_config()          # bench.py:92-93
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

    begin(4)
    # ---- 4: the same frame through the plain versions
    plain = plain_frame(rbm, bf, ("brick_field_tiles_wl",
                                  "brick_field_tiles_tp"), serve)
    mae, dmax, dop = frame_errors(frame, plain, "wl256 kernel frame vs plain")
    print(f"phase 4: plain frame rgb MAE {mae:.3e}, rgb max diff "
          f"{dmax:.3e}, opacity max diff {dop:.3e}", flush=True)

    begin(5)
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

    begin(6)
    # ---- 6: wl256 timings; K1 on every call of the request
    torch.cuda.reset_peak_memory_stats()
    wl_ms = frame_ms(serve, 3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = profile_frame(serve)
    print(f"phase 6: wl256 warm frames {wl_ms} ms; peak memory "
          f"{peak_gib:.2f} GiB; profiled frame: {breakdown}", flush=True)
    kernels = [measure(bf, "brick_field_tiles_wl", wl_calls, "wl256",
                       launches_a["brick_field_tiles_wl"], reps=20)]

    begin(7)
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
    begin(8)
    kernels += phase8(args.seed)
    gt = torch.as_tensor(ds.rays[0], device=dev)
    del baked5, geo5, frames
    torch.cuda.empty_cache()

    begin(9)
    # ---- 9: train bench.py's recipe; 10: serve the trained state
    state, tcfg, train, train_kernels = phase9(args.seed, dev)
    kernels += train_kernels
    begin(10)
    served = phase10(state, tcfg, o, d, gt, dev)

    begin(11)
    # ---- 11: bench.py's serving stages on the trained state
    stages, bench_keys, stage_kernels = phase11(state, tcfg, dev)
    kernels += stage_kernels
    trained = train_state_to_numpy(state)       # phase 19 starts from it
    del state
    torch.cuda.empty_cache()

    begin(12)
    # ---- 12: train_torch.py -> test_torch.py at opt.py's defaults
    cli, cli_kernels = phase12(args.seed)
    kernels += cli_kernels

    begin(13)
    # ---- 13: datasets on disk: NSVF and ScanNet through the CLIs
    scan_tmp = tempfile.TemporaryDirectory()     # phase 15 reads the scan
    t13 = time.time()
    data, data_kernels, scan = phase13(args.seed, scan_root=scan_tmp.name)
    data["seconds"] = time.time() - t13
    kernels += data_kernels

    begin(14)
    # ---- 14: the other encoders and the block marcher through the CLIs
    t14 = time.time()
    encoders, encoder_kernels = phase14(args.seed)
    encoders["seconds"] = time.time() - t14
    kernels += encoder_kernels

    begin(15)
    # ---- 15: the depth-prior path on phase 13's scan
    t15 = time.time()
    depth, depth_kernels = phase15(args.seed, scan)
    depth["seconds"] = time.time() - t15
    kernels += depth_kernels

    begin(16)
    # ---- 16: the cIMLE depth trainer on phase 13's scan
    depth_train = phase16(args.seed, scan)

    begin(17)
    # ---- 17: phase 13's scan as a .sens through scannet_tools and
    # training; 18: the shape refiner on its frames
    sens_chain, sens_kernels = phase17(args.seed, scan)
    kernels += sens_kernels
    begin(18)
    shape = phase18(args.seed, scan)
    scan_tmp.cleanup()

    begin(19)
    # ---- 19: data-parallel training and serving on the one card
    dp_run, dp_kernels = phase19(args.seed, trained)
    kernels += dp_kernels

    begin(20)
    # ---- 20: an RTMV scene of OpenEXR frames through the CLIs
    rtmv, rtmv_kernels = phase20(args.seed)
    kernels += rtmv_kernels

    begin(21)
    # ---- 21: a COLMAP scene of JPEG frames in every mode through the CLIs
    colmap, colmap_kernels = phase21(args.seed)
    kernels += colmap_kernels
    begin("end")
    print(f"card {card}; bake 256^3 {bake_s:.3f} s, 512^3 {bake5_s:.3f} s; "
          f"wl256 median {statistics.median(wl_ms):.2f} ms; " + "; ".join(
              f"{r} median {statistics.median(s['frame_ms']):.2f} ms"
              for r, s in summary.items())
          + f"; train {train['ms_per_step']:.3f} ms/step, psnr@"
          f"{train['steps']} {train['psnr_end']:.2f}; trained wl256 psnr "
          f"{served['psnr']:.2f}, median "
          f"{statistics.median(served['frame_ms']):.2f} ms; " + "; ".join(
              f"{n} warm {i['warm_ms']:.1f} ms, psnr {i['psnr']:.2f}"
              for n, i in stages.items() if "psnr" in i)
          + f"; cli train {cli['train'].get('ms_per_step')} ms/step, "
          f"validate psnr {cli['train']['psnr']:.2f}; " + "; ".join(
              f"cli {r} psnr {i['psnr']:.2f}, fps {i['fps']:.2f}"
              for r, i in cli["serve"].items())
          + f"; nsvf validate psnr {data['nsvf']['train']['psnr']:.2f}, "
          f"served {data['nsvf']['serve']['psnr']:.2f}; scannet validate "
          f"psnr sup {data['scannet']['train']['sup']['psnr']:.2f}, nosup "
          f"{data['scannet']['train']['nosup']['psnr']:.2f}, served "
          f"{data['scannet']['serve']['psnr']:.2f}; phase 13 "
          f"{data['seconds']:.0f} s; " + "; ".join(
              f"{r} {encoders[r].get('ms_per_step')} ms/step, validate "
              f"psnr {encoders[r]['psnr']:.2f}, served "
              f"{encoders[r]['serve']['psnr']:.2f}"
              for r, *_ in ENCODER_RUNS)
          + f"; phase 14 {encoders['seconds']:.0f} s; depth priors "
          f"{depth['cli_frame_ms_median']:.1f} ms a frame of "
          f"{DEPTH_SAMPLES}, forward {depth['forward_ms_per_frame']:.2f} "
          f"ms, phase 15 {depth['seconds']:.0f} s; depth training "
          f"{depth_train['step_ms_median']:.1f} ms a step, phase 16 "
          f"{depth_train['seconds']:.0f} s; .sens chain: depth decode "
          f"{sens_chain['decode']['depth_batch_ms']:.2f} ms a frame, export "
          f"{sens_chain['export_s']:.2f} s, {sens_chain['ms_per_step']} "
          f"ms/step, validate psnr {sens_chain['psnr']:.2f}, depth MAE "
          f"{sens_chain['depth_mae_m']:.4f} m, phase 17 "
          f"{sens_chain['seconds']:.0f} s; shape refiner "
          f"{shape['cli_s_per_frame']:.1f} s a frame, spvcnn_apply "
          f"{statistics.median(shape['refine'][0]['card_ms'][1:]):.1f} ms, "
          f"phase 18 {shape['seconds']:.0f} s; DP step at world 1 "
          f"{statistics.mean(dp_run['world1']['step_ms']['dp']):.3f} ms vs "
          f"plain {statistics.mean(dp_run['world1']['step_ms']['plain']):.3f}"
          f" ms, at world 2 on one card {dp_run['world2']['step_ms'][0]:.3f}"
          f" ms (not a scaling figure), phase 19 {dp_run['seconds']:.0f} s; "
          f"rtmv: EXR decode {rtmv['exr_decode_ms']:.1f} ms a frame, "
          f"{rtmv['ms_per_step']} ms/step, validate psnr {rtmv['psnr']:.2f}, "
          f"served {rtmv['serve']['psnr']:.2f}, phase 20 "
          f"{rtmv['seconds']:.0f} s; colmap: JPEG decode ms a frame "
          f"{colmap['decode_ms']}, {colmap['ms_per_step']} ms/step, "
          f"validate psnr {colmap['psnr']:.2f}, served "
          f"{colmap['serve']['psnr']:.2f}, phase 21 "
          f"{colmap['seconds']:.0f} s; total "
          f"{time.time() - t_start:.0f} s", flush=True)

    result = dict(card=card, seed=args.seed, bake_s=bake_s,
                  bake512_s=bake5_s, n_blocks_512=int(baked5_blocks),
                  wl256=dict(frame_ms=wl_ms, peak_gib=peak_gib,
                             counters=counters_of(frame),
                             launches=launches_a, profile=breakdown,
                             plain_frame_err=[mae, dmax, dop]),
                  requests=summary, n512_vs_t512=nt,
                  rgba_bake_ms=rgba_bake_ms, phase2_err=errs2,
                  train=train, trained_wl256=served, serving_stages=stages,
                  bench_keys=bench_keys, cli=cli, datasets=data,
                  encoders=encoders, depth=depth,
                  depth_train=depth_train, sens_chain=sens_chain,
                  shape=shape, dp=dp_run, rtmv=rtmv, colmap=colmap,
                  phase_began_s=started,
                  kernels=kernels)
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
