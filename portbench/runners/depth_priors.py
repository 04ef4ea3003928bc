"""Depth-prior traffic for the (cIMLE) LeReS model
(`depth/priors.frame_priors`, what depth_eval_scannet_torch.py runs for
every frame of a scan): a closed loop over frames, one at a time, each
complete when all its hypotheses, resized back to the frame's size, are
on the host.

Set-up builds the model on the device from the seed: weights as
`init_depth_model` draws them, then BatchNorm running statistics and
the AdaIN calibration shifts drawn from the seed too, so that their
arithmetic is checked.  It renders the frame pool from the benchmark's
procedural scene (lib/scene.py) at poses turned by the seed, and runs
the warm-up frames.  Latents are drawn as the CLI draws them: one
(minibatch, d_latent) normal draw a minibatch from a CPU generator
seeded by the seed.  The window runs frames until its time is up; the
frames it checks are drawn from the seed as they finish (a reservoir).
With --trace a profiled slice of frames follows.  Then the plain
reference (reference/depth.py) recomputes every hypothesis of the
checked frames from the program's state dict, the frames and the
latents, and each hypothesis is compared: its norm-relative distance
(`prior_rel`) and the 99.9th percentile of its per-pixel distance over
the reference's range (`prior_p999`), the worst of each.  `hyp_spread`,
printed and not compared, is the least norm-relative distance between
two reference hypotheses of a frame.

The control runs the program with TF32 allowed in its convolutions and
matmuls, and their operands rounded to TF32 as well, so that a CPU,
which has no TF32, computes in the same precision.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

from portbench.lib import common, compare, depth_spans, depth_work, scene
from portbench.reference import depth as rd
from portbench.runners.serve_oneshot import Reservoir


def _round_tf32(x):
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


class _TF32Operands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.conv2d, F.linear) and args[1].dtype == torch.float32:
            args = (_round_tf32(args[0]), _round_tf32(args[1])) + args[2:]
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _tf32_scope():
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    was = mm.allow_tf32
    mm.allow_tf32 = True
    try:
        with cd.flags(enabled=True, benchmark=cd.benchmark,
                      deterministic=cd.deterministic, allow_tf32=True), \
                _TF32Operands():
            yield
    finally:
        mm.allow_tf32 = was


@contextlib.contextmanager
def _patched(fault, control, priors):
    """The timed path with a fault planted, or in the control's
    precision (calibration and tests)."""
    from google_nerf_tpu_torch.depth import adain, model
    new = []
    if control:
        new.append((model, "exact_f32", _tf32_scope))
    if fault == "z_ignored":       # every AdaIN point skipped
        new.append((adain.AdaInMod, "forward", lambda self, x, z: x))
    elif fault == "shared_shift":  # one shift over every hypothesis
        new.append((priors, "MINIBATCH", 1 << 30))
    elif fault not in (None, "half_hyps"):
        raise ValueError(f"unknown fault {fault!r}")
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in new]
    for obj, name, v in new:
        setattr(obj, name, v)
    try:
        yield
    finally:
        for obj, name, v in old:
            setattr(obj, name, v)


@torch.no_grad()
def build_model(cfg, seed, dev):
    """The model from the seed: `init_depth_model`'s weights, BatchNorm
    running means N(0, 0.1^2) and variances U(0.5, 1.5), AdaIN shifts
    N(0, 0.1^2), all drawn on the device."""
    from google_nerf_tpu_torch.depth.adain import AdaInMod
    from google_nerf_tpu_torch.depth.model import init_depth_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_depth_model(gen, cfg, dev)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
        elif isinstance(m, AdaInMod):
            m.mean_shift.normal_(0.0, 0.1, generator=gen)
            m.var_shift.normal_(0.0, 0.1, generator=gen)
    return model


@torch.no_grad()
def frame_pool(n, w, h, radius, seed, dev, chunk=1 << 15):
    """(n, h, w, 3) RGB in [0, 1]: the procedural scene composited onto
    white from n poses on a spiral turned by the seed."""
    dirs = scene.pixel_directions(w, h, dev)
    out = []
    for p in torch.as_tensor(scene.fibonacci_poses(n, radius, seed),
                             device=dev):
        o, d = scene.rays(dirs, p)
        img = []
        for i in range(0, o.shape[0], chunk):
            rgb, a = scene.ground_truth(o[i:i + chunk], d[i:i + chunk])
            img.append(torch.clamp(rgb + (1.0 - a.clamp(0, 1))[:, None],
                                   0.0, 1.0))
        out.append(torch.cat(img).reshape(h, w, 3))
    return torch.stack(out)


def readings(got, want):
    """Worst hypothesis of the checked frames: norm-relative distance,
    and the 99.9th percentile of the per-pixel distance over the
    reference's range; and the least norm-relative distance between two
    reference hypotheses of a frame."""
    rel, p999, spread = 0.0, 0.0, float("inf")
    for g, w in zip(got, want):
        for k in range(w.shape[0]):
            wk = w[k].double()
            rel = max(rel, float((g[k].double() - wk).norm() / wk.norm()))
            p = compare.pixel_errors(g[k].reshape(-1), w[k].reshape(-1))[0]
            p999 = max(p999, p / float(w[k].max() - w[k].min()))
            for j in range(k + 1, w.shape[0]):
                spread = min(spread, float((w[j].double() - wk).norm()
                                           / wk.norm()))
    return dict(prior_rel=rel, prior_p999=p999, hyp_spread=spread)


def run(cell, *, seed, seconds, trace, device, fault=None, control=False):
    start = common.t0()
    dev = torch.device(device)
    from google_nerf_tpu_torch.depth import priors
    from google_nerf_tpu_torch.depth.model import DepthModelConfig
    from google_nerf_tpu_torch.utils import logging as plog
    conf, tr = cell.config, cell.traffic
    if priors.MINIBATCH != tr["minibatch"]:
        raise ValueError(f"the program runs minibatches of "
                         f"{priors.MINIBATCH}, the traffic {tr['minibatch']}")
    cfg = DepthModelConfig(**conf["model"])
    W, H = tr["frame"]["width"], tr["frame"]["height"]
    crop, n_z, mb = tr["crop"], tr["hypotheses"], tr["minibatch"]
    model = build_model(cfg, seed, dev)
    pool = frame_pool(tr["pool"], W, H, tr["radius"], seed, dev)
    gen = torch.Generator().manual_seed(seed)
    out = dict(attempted=0, failed=0, dtype=conf["precision"]["compute"],
               tf32=conf["precision"]["tf32"],
               work=depth_work.frame_work(conf, crop, n_z, mb))

    def latents():
        return torch.cat([torch.randn((min(mb, n_z - s), cfg.d_latent),
                                      generator=gen)
                          for s in range(0, n_z, mb)])

    def frame(i):
        z = latents()
        zp = torch.cat([z[:mb]] * 2)[:n_z] if fault == "half_hyps" else z
        p = priors.frame_priors(model, pool[i % len(pool)], zp.to(dev), crop,
                                (H, W))
        return z, p.cpu()

    with _patched(fault, control, priors):
        for i in range(tr["warmup_frames"]):
            frame(i)
        common.sync(dev)
        pick, lat = Reservoir(seed, tr["check"]["frames"]), []
        t_w = time.perf_counter()
        out["setup_s"] = t_w - start
        i = 0
        while True:
            t_req = time.perf_counter()
            z, p = frame(i)
            lat.append(time.perf_counter() - t_req)
            pick.offer(i, lambda: (i % len(pool), z, p))
            i += 1
            if time.perf_counter() - t_w >= seconds:
                break
        out["window_s"] = time.perf_counter() - t_w
        out.update(views=i, attempted=i)
        if trace:
            n = tr["trace_frames"]
            before = plog.counters()
            t = common.traced(lambda: [frame(i + k) for k in range(n)], dev)
            moved = {k: v - before.get(k, 0)
                     for k, v in plog.counters().items()}
            red = depth_spans.reduce(t)
            out["trace"] = dict(window_s=t.window_s, busy_s=t.busy_s,
                                frames=n, spans=red["spans"],
                                coverage=red["coverage"], counters=moved)
            out["breakdown"] = common.breakdown(t)
    out["device"] = common.device_block(dev)
    if trace:
        out["device"].update(busy_s=out["trace"]["busy_s"],
                             window_s=out["trace"]["window_s"])
    common.say(f"setup {out['setup_s']:.3f} s, {i} frames in "
               f"{out['window_s']:.3f} s, median latency "
               f"{1e3 * statistics.median(lat):.2f} ms; card",
               common.card_line() if dev.type == "cuda" else "cpu")
    sd = model.state_dict()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = pick.views()
    want = [rd.frame_priors(sd, pool[j], z.to(dev), crop, (H, W),
                            minibatch=mb) for j, z, _ in kept.values()]
    got = [p.to(dev) for _, _, p in kept.values()]
    out["readings"] = readings(got, want)
    common.say("checked frames", sorted(kept), "readings", out["readings"])
    if trace:
        common.say("spans", {k: round(1e3 * v["fwd_s"] / n, 3)
                             for k, v in out["trace"]["spans"].items()},
                   "ms a frame; coverage", out["trace"]["coverage"],
                   "counters", out["trace"]["counters"])
    return out
