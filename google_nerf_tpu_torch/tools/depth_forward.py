"""Time the LeReS depth forward on the card: the path of
depth_eval_scannet_torch.py at the CLIs' defaults (ResNeXt101-32x8d,
encoder-site cIMLE at d_latent 32, crop 448), one frame = two
minibatches of 5 hypotheses, random weights from --seed.

    python -m google_nerf_tpu_torch.tools.depth_forward [--seed N]
        [--reps N] [--profile] [--out result.json]

Variants, each timed by CUDA events over --reps frames after a warm-up
and in turns (the first one again last, to show the spread):

  nchw              the port's path: NCHW, f32, TF32 off (exact_f32);
                    the decoder's 3x3s on ops/cuda/conv3x3's kernel
  nchw+benchmark    cudnn.benchmark on (cuDNN times its algorithms for
                    each shape at the first call)
  tf32              TF32 allowed in cuDNN: not the port's path (JAX's
                    reference is f32); what TF32 would give the encoder
                    (the decoder's kernel is f32 whatever the flags)

The decoder's kernel takes NCHW only, so channels_last is no variant.

Each line: ms a frame, images/s, peak memory (max_memory_allocated
over the timed frames, cuDNN's workspaces included) and the output's
norm-relative distance from the nchw variant's on the same inputs.
--profile adds the device ops of one nchw frame by torch.profiler,
summed by name.  Runs on the card only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                               depth_inference,
                                               init_depth_model)
from google_nerf_tpu_torch.tools.kernel_probe import cuda_ms

CROP, LATENT, MINIBATCH = 448, 32, 5


@contextlib.contextmanager
def _cudnn_benchmark(on: bool):
    was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = on
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = was


@contextlib.contextmanager
def _tf32():
    """TF32 allowed in cuDNN inside exact_f32's scope (which turns it
    off): exact_f32 is replaced for the variant's calls."""
    import google_nerf_tpu_torch.depth.model as dm
    orig = dm.exact_f32
    dm.exact_f32 = contextlib.nullcontext
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        dm.exact_f32 = orig
        torch.backends.cudnn.allow_tf32 = was


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("depth_forward: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = DepthModelConfig(backbone="resnext101_32x8d", d_latent=LATENT)
    model = init_depth_model(torch.Generator().manual_seed(args.seed), cfg,
                             dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    rgb = torch.rand((1, 3, CROP, CROP), generator=gen).expand(
        MINIBATCH, -1, -1, -1).contiguous().to(dev)
    zs = [torch.randn((MINIBATCH, LATENT), generator=gen).to(dev)
          for _ in range(2)]

    def variant(bench=False, tf32=False):
        def frame():
            return [depth_inference(model, rgb, z) for z in zs]

        def run():
            with _cudnn_benchmark(bench), \
                    (_tf32() if tf32 else contextlib.nullcontext()):
                out = frame()                         # warm-up, output
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(frame, args.reps)
            return out, ms, torch.cuda.max_memory_allocated() / 2 ** 30
        return run

    variants = [("nchw", variant()),
                ("nchw+benchmark", variant(bench=True)),
                ("tf32", variant(tf32=True)),
                ("nchw (again)", variant())]
    card = torch.cuda.get_device_name(0)
    results, ref = [], None
    for name, run in variants:
        out, ms, peak = run()
        out = torch.cat(out).float()
        if ref is None:
            ref = out
        rel = float((out - ref).norm() / ref.norm())
        r = dict(variant=name, ms_per_frame=ms,
                 images_per_s=2 * MINIBATCH * 1e3 / ms, peak_gib=peak,
                 rel_to_nchw=rel)
        results.append(r)
        print(f"{name}: {ms:.2f} ms a frame of {2 * MINIBATCH} "
              f"({r['images_per_s']:.1f} images/s), peak {peak:.2f} GiB, "
              f"{rel:.2e} from nchw", flush=True)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for z in zs:
                depth_inference(model, rgb, z)
            torch.cuda.synchronize()
        ops = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in p.key_averages()
                      if e.device_time_total > 0),
                     key=lambda t: -t[1])
        total = sum(t[1] for t in ops)
        prof = dict(device_ms=total, ops=[dict(name=k[:120], ms=v, calls=c)
                                          for k, v, c in ops[:15]])
        print(f"profile (nchw, one frame): device {total:.2f} ms; "
              + "; ".join(f"{k[:60]} {v:.2f} ms ({c})"
                          for k, v, c in ops[:10]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, crop=CROP, d_latent=LATENT,
                           minibatch=MINIBATCH, variants=results,
                           profile=prof), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
