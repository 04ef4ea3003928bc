"""Serving traffic for the one-shot renderer
(`models/render_test_oneshot.render_test_oneshot`): a closed loop of one
viewer asking for views in turn along an orbit of poses, each view
complete when its rgb is on the host.

Set-up makes the field's weights on the device from the seed and the
scene (lib/surface.py: a field whose rays end at the scene's surface),
the occupancy from the scene's geometry and the renderer's tables from
it, and serves two views.  The window serves views until its time is
up.  The seed picks where on the orbit the viewer starts, so every seed
serves the same poses in another order.  A sample of the views the
window finished is drawn from the seed as they finish (a reservoir, so
every run checks as many views).  After the window the program's state
is freed and the plain reference (reference/render.py) renders the
sampled views on the same inputs.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.lib import common, compare, program, scene, surface
from portbench.reference import field as rf
from portbench.reference import render as rr


def _fault(fault, out, R):
    if fault is None:
        return out
    out = dict(out)
    if fault == "half_rays":       # half the view's rays left out
        h = R // 2
        out["rgb"] = out["rgb"].clone()
        out["rgb"][h:] = 1.0
        out["opacity"] = out["opacity"].clone()
        out["opacity"][h:] = 0.0
        out["depth"] = out["depth"].clone()
        out["depth"][h:] = 0.0
    elif fault == "altered":       # a patch of the answer altered
        out["rgb"] = out["rgb"].clone()
        out["rgb"][:1024] += 0.05
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return out


def start_pose(seed, n_poses: int) -> int:
    """Where on the orbit the seed's viewer starts."""
    return int(np.random.default_rng(int(seed) % (1 << 63)).integers(
        n_poses))


class Reservoir:
    """k of the views served so far, drawn uniformly from the seed
    whatever their number (Algorithm R)."""

    def __init__(self, seed, k: int):
        self.rng = np.random.default_rng(int(seed) % (1 << 63))
        self.k = k
        self.kept = {}          # slot -> (view index, outputs)

    def offer(self, i: int, outputs):
        """Keep view i's outputs (a callable) if it is drawn."""
        slot = i if i < self.k else int(self.rng.integers(i + 1))
        if slot < self.k:
            self.kept[slot] = (i, outputs())

    def views(self):
        return dict(sorted(self.kept.values(), key=lambda x: x[0]))


def control_views(seed, k: int, n_poses: int):
    """The views the control renders: k poses drawn from the seed."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    return sorted(int(i) for i in rng.choice(n_poses, size=k, replace=False))


def readings(got, want):
    """The worst over the checked views of each pixel-error statistic."""
    r = {}
    for key in ("rgb", "opacity", "depth"):
        stats = [compare.pixel_errors(g[key], w[key])
                 for g, w in zip(got, want)]
        r[f"{key}_p999"] = max(s[0] for s in stats)
        r[f"{key}_mean"] = max(s[1] for s in stats)
        r[f"{key}_max"] = max(s[2] for s in stats)
    return r


def run(cell, *, seed, seconds, trace, device, fault=None, control=False):
    start = common.t0()
    dev = torch.device(device)
    conf, tr = cell.config, cell.traffic
    prec = rf.precision_of(conf["precision"], False)
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    spec = rf.field_spec(conf["model"])
    G = conf["model"]["grid_size"]
    st = tr["settings"]
    W, H = tr["view"]["width"], tr["view"]["height"]
    orbit = tr["orbit"]
    poses = torch.as_tensor(scene.orbit_poses(
        orbit["poses"], orbit["radius"], orbit["elevation_deg"]),
        device=dev)
    first = start_pose(seed, orbit["poses"])
    pose_of = lambda i: (first + i) % orbit["poses"]  # noqa: E731
    p0 = surface.surface_params(spec, seed, dev, max_samples=st[
        "max_samples"], **tr["field"])
    occ = scene.occupancy(G, spec.scale, dev)
    out = dict(attempted=0, failed=0, spec=spec, dtype=conf["precision"][
        "compute"], tf32=prec.tf32)
    ref_dirs = scene.pixel_directions(W, H, dev)

    def reference(p, pr, views):
        f = rf.Field(spec, p, pr)
        res = []
        for v in views:
            o, d = scene.rays(ref_dirs, poses[pose_of(v)])
            res.append(rr.render_view(
                f, occ, o, d, max_samples=st["max_samples"],
                T_threshold=st["T_threshold"], group=tr["march_group"]))
        return res

    if control:
        views = control_views(seed, tr["check"]["views"], orbit["poses"])
        got = reference(p0, rf.precision_of(conf["precision"], True), views)
        want = reference(p0, prec, views)
        out.update(readings=readings(got, want), metrics_skip=True,
                   device=common.device_block(dev))
        return out

    from google_nerf_tpu_torch.core.rays import get_ray_directions, get_rays
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
    ngp = program.ngp_config(conf["model"])
    program.check_layout(ngp, spec)
    params = program.program_params(spec, p0)
    occ2 = pack_occupancy_block2(occ, max_samples=st["max_samples"],
                                 scale=ngp.scale)
    dirs = get_ray_directions(H, W, scene.intrinsics(W, H), device=dev)

    def serve(i):
        o, d = get_rays(dirs, poses[pose_of(i)])
        res = render_test_oneshot(params, ngp, occ2, o, d, **st)
        res = _fault(fault, res, o.shape[0])
        return res, res["rgb"].cpu()

    for i in range(2):
        serve(i)
    common.sync(dev)
    pick, lat, trips = Reservoir(seed, tr["check"]["views"]), [], []
    t_w = time.perf_counter()
    out["setup_s"] = t_w - start
    i = 0
    while True:
        t_req = time.perf_counter()
        res, rgb = serve(i)
        lat.append(time.perf_counter() - t_req)
        trips.append(res.get("drain_trips"))
        pick.offer(i, lambda: dict(
            rgb=rgb, opacity=res["opacity"].clone(),
            depth=res["depth"].clone(), alive=res.get("alive_after_main")))
        i += 1
        if time.perf_counter() - t_w >= seconds:
            break
    out["window_s"] = time.perf_counter() - t_w
    kept = pick.views()
    out.update(views=i, latencies_s=lat, attempted=i, failed=0)
    if trace:
        n = tr["trace_views"]
        t = common.traced(lambda: [serve(i + k) for k in range(n)], dev)
        out["trace"] = dict(window_s=t.window_s, busy_s=t.busy_s, views=n,
                            launches=t.launches())
        out["breakdown"] = common.breakdown(t)
    out["device"] = common.device_block(dev)
    if trace:
        out["device"].update(busy_s=out["trace"]["busy_s"],
                             window_s=out["trace"]["window_s"])
    common.say(f"setup {out['setup_s']:.3f} s, {i} views in "
               f"{out['window_s']:.3f} s, median latency "
               f"{1e3 * statistics.median(lat):.2f} ms; card",
               common.card_line() if dev.type == "cuda" else "cpu")
    del params, occ2, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    views = sorted(kept)
    want = reference(p0, prec, views)
    got = [dict(rgb=kept[v]["rgb"].to(dev), opacity=kept[v]["opacity"],
                depth=kept[v]["depth"]) for v in views]
    out["readings"] = readings(got, want)
    common.say("readings", out["readings"])
    out["needed_per_view"] = statistics.mean(w["needed"] for w in want)
    by_pose = {}
    for k, x in enumerate(lat):
        by_pose.setdefault(pose_of(k), []).append(1e3 * x)
    common.say("median latency ms by pose", {
        p: round(statistics.median(v), 1) for p, v in sorted(by_pose.items())})
    common.say("checked views", views, "samples needed a view",
               [w["needed"] for w in want], "rays ended by the threshold",
               [w["ended"] for w in want], "program's drain trips",
               [trips[v] for v in views], "rays alive after its scan",
               [int(kept[v]["alive"]) for v in views
                if kept[v]["alive"] is not None])
    common.say("drain trips a view over the window: min", min(trips),
               "median", statistics.median(trips), "max", max(trips))
    return out
