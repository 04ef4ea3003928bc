"""The depth-prior cell (`leres_cimle_rx101.priors_448`) at a size a test
run holds, on the CPU: the published ResNeXt101-32x8d widths at a 64^2
crop of 48x64 frames, 10 hypotheses in minibatches of 5.  A sound run
of the program is correct; the control (TF32 operands, emulated where
there is no TF32) and each fault planted in the timed path are not;
a traced run reads the cell's per-layer metrics that a CPU slice has;
and lib/depth_spans.reduce gives a synthetic trace's kernels to the
innermost span.

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import depth_spans, harness, trace  # noqa: E402

CELL = "leres_cimle_rx101.priors_448"
SEED = 2 ** 31 + 777
TOY = dict(traffic=dict(frame=dict(width=64, height=48), pool=2, crop=64,
                        warmup_frames=1, trace_frames=1))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(trace=False, **kw):
    harness.T0 = None
    readings = {}
    res = harness.execute(ROOT, CELL, SEED, 0.5, trace, device="cpu",
                          overrides=TOY, readings=readings, **kw)
    return res, readings


def test_sound_run_is_correct():
    res, readings = run()
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == {"prior_rel", "prior_p999"}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {"setup_s", "frame_ms"} == set(res["metrics"])
    # the latents move the priors by far more than the limits
    assert readings["hyp_spread"] > 100 * max(
        c["limit"] for c in res["compared"].values())


def test_traced_run_reads_per_layer_metrics():
    res, _ = run(trace=True)
    assert res["correct"], res["compared"]
    # a CPU slice has no device time: the rooflines have nothing to read
    assert set(res["metrics"]) == {"priors.mfu", "priors.device_idle_share"}
    assert 0 < res["metrics"]["priors.mfu"]["value"] < 100
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_is_not_correct():
    res, readings = run(control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["z_ignored", "half_hyps",
                                   "shared_shift"])
def test_faults_are_not_correct(fault):
    res, _ = run(fault=fault)
    assert not res["correct"], (fault, res["compared"])


def _ev(name, cat, ts, dur, tid=1, args=None):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid,
                args=dict(args or {}))


def _launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return _ev(name, "cuda_runtime", ts, 1, tid, {"correlation": corr})


def _kernel(ts, dur, corr):
    return _ev(f"k{corr}", "kernel", ts, dur, tid=7,
               args={"correlation": corr})


def test_depth_spans_give_kernels_to_the_innermost_span():
    """A 1000 us slice holding one frame (100-900): a resize, an encoder
    with one AdaIN point inside it, a decoder, and the root's own
    launch; one kernel before the frame, outside every span.  Busy 100
    us: resize 5, encoder 20 + 10, AdaIN 8, decoder 40, root 7, outside
    10."""
    events = [
        _ev("portbench.window", "user_annotation", 0, 1000),
        _ev("depth.priors.frame", "user_annotation", 100, 800),
        _ev("depth.resize", "user_annotation", 110, 20),
        _ev("depth.encoder", "user_annotation", 200, 300),
        _ev("depth.adain", "user_annotation", 250, 50),
        _ev("depth.decoder", "user_annotation", 600, 200),
        _launch(50, 1), _kernel(60, 10, 1),
        _launch(115, 2), _kernel(120, 5, 2),
        _launch(210, 3), _kernel(220, 20, 3),
        _launch(260, 4, "cuLaunchKernel"), _kernel(270, 8, 4),
        _launch(400, 5), _kernel(410, 10, 5),
        _launch(610, 6), _kernel(620, 40, 6),
        _launch(850, 7), _kernel(860, 7, 7),
    ]
    red = depth_spans.reduce(trace.Trace(events, "portbench.window"))
    s = red["spans"]
    us = lambda x: round(x * 1e6, 6)  # noqa: E731
    assert {n: us(v["fwd_s"]) for n, v in s.items()} == {
        "depth.priors.frame": 7, "depth.resize": 5, "depth.encoder": 30,
        "depth.adain": 8, "depth.decoder": 40}
    assert us(s["depth.encoder"]["total_s"]) == 38
    assert us(s["depth.priors.frame"]["total_s"]) == 90
    assert all(v["calls"] == 1 for v in s.values())
    assert us(red["outside_s"]) == 10 and us(red["busy_s"]) == 100
    assert us(red["layer_s"]) == 83
    assert red["coverage"] == pytest.approx(0.83)
    # each idle gap goes to the innermost span at its midpoint: 0-60 and
    # 70-120 and 867-1000 outside, 125-220 and 420-620 the root's,
    # 240-270 the AdaIN's, 278-410 the encoder's, 660-860 the decoder's
    assert us(red["outside_idle_s"]) == 60 + 50 + 133
    assert {n: us(v["idle_s"]) for n, v in s.items()} == {
        "depth.priors.frame": 95 + 200, "depth.resize": 0,
        "depth.encoder": 132, "depth.adain": 30, "depth.decoder": 200}
