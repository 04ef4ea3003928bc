"""The depth priors of a frame (google_nerf_tpu_torch/depth/priors.py)
on the CPU: against the benchmark's plain reference
(portbench/reference/depth.py) on seeded random weights with drawn
BatchNorm statistics and AdaIN shifts, at the published ResNeXt101-32x8d
widths and a 64^2 crop; the reference's independence from the port;
the work it counts (portbench/lib/depth_work.py) against the program's
own convolutions and linear layers; the spans and counters of one
frame; and depth_eval_scannet_torch.py's priors, unchanged by the move
of its loop into frame_priors.

Tolerances: the program against the float32 reference, norm-relative
1e-5 for each hypothesis (float32 sums in another order: the reference
writes BatchNorm out and resizes by interpolation-matrix products; seen
up to 1.6e-6); the same tolerance fails the reference computed in
bfloat16 (seen ~1e-2).  The CLI's priors equal the inline loop's it
replaced bit for bit, and the pinned sums of that loop's output to 1e-6
of each file's sum (the same on 2 and 5 threads here; another CPU's
convolutions may round otherwise).
"""
import ast
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import depth_eval_scannet_torch
from depth_test_torch import build_model, read_rgb01
from google_nerf_tpu_torch.depth import priors
from google_nerf_tpu_torch.depth.adain import AdaInMod
from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                               depth_inference,
                                               init_depth_model)
from google_nerf_tpu_torch.utils import logging as tlog
from google_nerf_tpu_torch.utils.image import resize_linear, write_png
from portbench.lib import depth_work
from portbench.reference import depth as rd

ROOT = Path(__file__).resolve().parents[1]
CROP, FRAME_HW, N_Z, MB = 64, (48, 64), 4, 2
REL = 1e-5
PUBLISHED = dict(stem=dict(out=64, kernel=7, stride=2), layers=[3, 4, 23, 3],
                 planes=[64, 128, 256, 512], groups=32, width_per_group=8,
                 expansion=4, decoder_mid=[256, 256, 256, 512],
                 adain_mlp=[512, 256, 128])


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The published ResNeXt101-32x8d cIMLE model (d_latent 32) from a
    seed, its BatchNorm statistics and AdaIN shifts drawn; a frame and
    four latents."""
    g = torch.Generator().manual_seed(11)
    model = init_depth_model(g, DepthModelConfig(d_latent=32), "cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, AdaInMod):
                m.mean_shift.normal_(0.0, 0.1, generator=g)
                m.var_shift.normal_(0.0, 0.1, generator=g)
    rgb = torch.rand(FRAME_HW + (3,), generator=g)
    z = torch.randn((N_Z, 32), generator=g)
    return model, rgb, z


def program(world, monkeypatch):
    model, rgb, z = world
    monkeypatch.setattr(priors, "MINIBATCH", MB)
    return priors.frame_priors(model, rgb, z, CROP, FRAME_HW)


def rel(a, b):
    return [float((a[k].double() - b[k].double()).norm()
                   / b[k].double().norm()) for k in range(b.shape[0])]


def test_frame_priors_match_the_reference(world, monkeypatch):
    model, rgb, z = world
    got = program(world, monkeypatch)
    want = rd.frame_priors(model.state_dict(), rgb, z, CROP, FRAME_HW,
                           minibatch=MB)
    assert got.shape == want.shape == (N_Z,) + FRAME_HW
    assert max(rel(got, want)) <= REL, rel(got, want)
    # one shift a minibatch: each minibatch's least prior is at 0.01
    # before the resize back, so the priors sit at or above it
    assert float(want.min()) >= 0.01 - 1e-6
    # the latents move the priors by far more than the tolerance
    assert float((want[1] - want[0]).norm() / want[0].norm()) > 1e3 * REL


def test_the_tolerance_fails_a_bfloat16_reference(world, monkeypatch):
    model, rgb, z = world
    got = program(world, monkeypatch)
    low = rd.frame_priors(model.state_dict(), rgb, z, CROP, FRAME_HW,
                          minibatch=MB, dtype=torch.bfloat16)
    assert min(rel(low, got)) > 10 * REL, rel(low, got)


def test_reference_imports_nothing_of_the_port():
    path = ROOT / "portbench" / "reference" / "depth.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "typing", "numpy",
                     "torch"}, names
    loaded = subprocess.run(
        [sys.executable, "-c", "import sys; import portbench.reference."
         "depth; print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=str(ROOT), capture_output=True, text=True, check=True).stdout
    for bad in ("google_nerf_tpu_torch", "google_nerf_tpu", "jax",
                "jaxlib", "flax"):
        assert f"'{bad}'" not in loaded, bad


@pytest.mark.parametrize("crop", [64, 96])
def test_work_counts_the_programs_layers(world, crop):
    """depth_work's multiply-adds, from the published shapes, against
    every convolution's and linear layer's of one forward."""
    model = world[0]
    macs = dict(encoder=0, decoder=0, adain=0)

    def hook(part):
        def count(m, args, out):
            w = m.weight
            macs[part] += out.numel() * (w[0].numel() if w.ndim == 4
                                         else m.in_features)
        return count

    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            part = ("adain" if ".style_mod" in name else
                    "encoder" if name.startswith("encoder") else "decoder")
            hooks.append(m.register_forward_hook(hook(part)))
    try:
        with torch.no_grad():
            model(torch.rand(1, 3, crop, crop), torch.randn(1, 32))
    finally:
        for h in hooks:
            h.remove()
    conf = dict(published=PUBLISHED, model=dict(d_latent=32))
    w = depth_work.frame_work(conf, crop, 1, 5)
    assert (w["encoder_macs"], w["decoder_macs"], w["adain_macs"]) == (
        macs["encoder"], macs["decoder"], macs["adain"])
    # the four AdaIN points: the stem's output and stages 1-3's
    s = crop // 2
    assert w["adain_elems"] == 64 * s * s + 256 * (s // 2) ** 2 \
        + 512 * (s // 4) ** 2 + 1024 * (s // 8) ** 2


def _traced(fn):
    before = tlog.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = tlog.counters()
    events = [e for e in prof.events()]
    return out, events, {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}


def _nested(events, others=()):
    """{depth.* span or a name in others: set of the depth.* spans
    directly around its calls}."""
    iv = [(e.time_range.start, e.time_range.end, e.name) for e in events
          if e.name.startswith("depth.") or e.name in others]
    parents = {}
    for a, b, name in iv:
        around = [(b2 - a2, n2) for a2, b2, n2 in iv
                  if n2.startswith("depth.") and a2 <= a and b <= b2
                  and (a2, b2) != (a, b)]
        parents.setdefault(name, set()).add(min(around)[1] if around
                                            else None)
    return parents


def test_one_frame_spans_nest_and_count(world, monkeypatch):
    out, events, moved = _traced(lambda: program(world, monkeypatch))
    parents = _nested(events)
    assert parents == {
        "depth.priors.frame": {None},
        "depth.resize": {"depth.priors.frame"},
        "depth.encoder": {"depth.priors.frame"},
        "depth.adain": {"depth.encoder"},
        "depth.decoder": {"depth.priors.frame"}}, parents
    names = [e.name for e in events if e.name.startswith("depth.")]
    # two minibatches: two encoders and decoders, eight AdaIN points, the
    # input's resize, each minibatch's normalisation and shift, the
    # priors' resize back
    assert names.count("depth.encoder") == names.count("depth.decoder") == 2
    assert names.count("depth.adain") == 8
    assert names.count("depth.resize") == 6
    assert moved == {"depth_frames": 1, "depth_hypotheses": N_Z}


def test_no_span_or_counter_without_a_profiler(world, monkeypatch):
    before = tlog.counters()
    assert tlog.span("depth.encoder") is tlog.span("depth.adain")
    assert isinstance(tlog.span("depth.priors.frame"),
                      contextlib.nullcontext)
    a = program(world, monkeypatch)
    assert tlog.counters() == before
    b, _, _ = _traced(lambda: program(world, monkeypatch))
    assert torch.equal(a, b)


# the sums of depth_eval_scannet_torch's priors before its loop moved
# into frame_priors (resnet50, d_latent 8, 7 hypotheses, seed 3)
PINNED = {
    "0.npy": 3721.341176688671, "0-sample1.npy": 4221.201698318124,
    "0-sample2.npy": 4286.209677636623, "0-sample3.npy": 4060.2863537818193,
    "0-sample4.npy": 4006.4436676204205, "0-sample5.npy": 4473.680978015065,
    "0-sample6.npy": 4126.701555944979, "1.npy": 7797.302349820733,
    "1-sample1.npy": 7108.025535047054, "1-sample2.npy": 6637.714111685753,
    "1-sample3.npy": 5991.830175459385, "1-sample4.npy": 7061.7709503769875,
    "1-sample5.npy": 5288.651963606477, "1-sample6.npy": 5765.847614765167}


def _inline_loop(scene, d_latent, n_z, crop, seed):
    """The loop depth_eval_scannet_torch.main ran before frame_priors:
    {file name: prior}."""
    cfg = DepthModelConfig(backbone="resnet50", d_latent=d_latent)
    model = build_model(cfg, None, "cpu")
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for fi, name in enumerate(sorted(os.listdir(os.path.join(scene,
                                                             "rgb")))):
        rgb = read_rgb01(os.path.join(scene, "rgb", name))
        h, w = rgb.shape[:2]
        inp = resize_linear(torch.from_numpy(rgb),
                            (crop, crop)).permute(2, 0, 1)[None]
        preds = []
        for start in range(0, n_z, 5):
            m = min(5, n_z - start)
            z = torch.randn((m, d_latent), generator=gen)
            preds.append(depth_inference(
                model, inp.expand(m, -1, -1, -1).contiguous(), z)[:, 0])
        preds = torch.cat(preds)
        for k in range(n_z):
            suffix = "" if k == 0 else f"-sample{k}"
            out[name[:-4] + suffix + ".npy"] = resize_linear(
                preds[k], (w, h)).numpy()
    return out


def test_scannet_cli_writes_the_priors_it_wrote_before(tmp_path):
    scene = tmp_path / "scene"
    os.makedirs(scene / "rgb")
    rng = np.random.default_rng(7)
    for i in range(2):
        write_png(str(scene / "rgb" / f"{i}.png"),
                  rng.integers(0, 256, FRAME_HW + (3,)).astype(np.uint8))
    out = tmp_path / "out"
    depth_eval_scannet_torch.main(
        ["--scene_dir", str(scene), "--out_dir", str(out), "--backbone",
         "resnet50", "--d_latent", "8", "--num_samples", "7",
         "--all_samples", "--crop_size", "64", "--seed", "3",
         "--platform", "cpu"])
    got = {n: np.load(out / n) for n in os.listdir(out)}
    assert sorted(got) == sorted(PINNED)
    want = _inline_loop(str(scene), 8, 7, 64, 3)
    for n, d in got.items():
        assert d.dtype == np.float32 and d.shape == FRAME_HW
        np.testing.assert_array_equal(d, want[n], err_msg=n)
        assert abs(d.astype(np.float64).sum() - PINNED[n]) <= \
            1e-6 * PINNED[n], n


class _Piece:
    """A stand-in for a captured graph: its replay runs one op."""

    def __init__(self, tag):
        self.tag = tag

    def replay(self):
        with torch.autograd.profiler.record_function(self.tag):
            torch.ones(1)


def test_replay_runs_each_piece_inside_its_spans():
    """priors.replay, which runs the card's graph pieces of a forward,
    opens a span once across consecutive pieces inside it and nests the
    pieces' work as the capture saw it."""
    e, a = "depth.encoder", "depth.adain"
    pieces = [((), _Piece("p0"), {}), ((e,), _Piece("p1"), {}),
              ((e, a), _Piece("p2"), {}), ((e,), _Piece("p3"), {}),
              ((e, a), _Piece("p4"), {}), ((), _Piece("p5"), {}),
              (("depth.decoder",), _Piece("p6"), {})]
    _, events, _ = _traced(lambda: priors.replay(pieces))
    names = [x.name for x in events]
    assert names.count(e) == 1 and names.count(a) == 2
    parents = _nested(events, others={p.tag for _, p, _ in pieces})
    assert parents["p0"] == parents["p5"] == {None}
    assert parents["p1"] == parents["p3"] == {e}
    assert parents["p2"] == parents["p4"] == {a}
    assert parents["p6"] == {"depth.decoder"}
    assert parents[a] == {e}
