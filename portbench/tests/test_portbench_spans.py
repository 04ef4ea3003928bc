"""The program's spans and counters as the benchmark reads them, on the
CPU: lib/program_spans.reduce on a synthetic trace worked by hand
(innermost forward attribution, the fold into ngp.grid_update, the
backward by autograd sequence number on another thread, idle gaps at
their midpoint, coverage); span_table's per-step table; and a traced
toy run of the serving cell reading the counter metrics.

    python -m pytest portbench/tests -q
"""
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import harness, program_spans, trace  # noqa: E402

SERVE_CELL = "ngp_hash_s05.serve_oneshot_800"
SEED = 2 ** 31 + 4242
SERVE = dict(
    model=dict(grid_size=16, num_levels=2, log2_hashmap_size=8),
    traffic=dict(view=dict(width=48, height=48),
                 settings=dict(k=32, max_samples=64, T_threshold=0.01,
                               budget_div=0, straggler_div=2, drain=True,
                               march="block2", compact_main=True,
                               chunk=1024),
                 march_group=8, check=dict(views=2), trace_views=2))


def _ev(name, cat, ts, dur, tid=1, args=None):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid,
                args=dict(args or {}))


def _launch(ts, corr, tid=1, dur=1):
    return _ev("cudaLaunchKernel", "cuda_runtime", ts, dur, tid,
               {"correlation": corr})


def _kernel(ts, dur, corr):
    return _ev(f"k{corr}", "kernel", ts, dur, tid=7,
               args={"correlation": corr})


def _op(name, ts, seq, tid=1, dur=5, fwd_tid=0):
    return _ev(name, "cpu_op", ts, dur, tid,
               {"Sequence number": seq, "Fwd thread id": fwd_tid})


def _bwd(node, ts, dur, seq, fwd_tid=1, tid=2):
    args = {} if seq is None else {"Sequence number": seq,
                                   "Fwd thread id": fwd_tid}
    return _ev(f"autograd::engine::evaluate_function: {node}", "cpu_op",
               ts, dur, tid, args)


def step_trace():
    """A 1000 us slice: a grid update (0-100) and one step (200-900)
    whose backward (500-700) runs on thread 2.  Eleven kernels, 178 us
    busy: the grid update's 15, the march's 20, the root's own 5 and 2
    (an AccumulateGrad), the encoder's 30 and 40, the MLP's 10 and 16,
    Adam's 30, and 10 outside every span."""
    return [
        _ev("portbench.window", "user_annotation", 0, 1000),
        _ev("ngp.grid_update", "user_annotation", 0, 100),
        _ev("ngp.encoder", "user_annotation", 10, 28),
        _ev("ngp.mlp", "user_annotation", 42, 18),
        _ev("ngp.train.step", "user_annotation", 200, 700),
        _ev("ngp.march", "user_annotation", 210, 40),
        _ev("ngp.encoder", "user_annotation", 300, 50),
        _ev("ngp.mlp", "user_annotation", 360, 40),
        _ev("ngp.adam", "user_annotation", 750, 50),
        # an op making no node records the next node's number (7) too
        _op("aten::add", 290, 7),
        _op("_PackedHashEncode", 310, 7),
        _op("aten::mm", 370, 8),
        # another thread's forward op with number 8 (outvoted)
        _op("aten::mul", 380, 8, tid=3),
        _bwd("MmBackward0", 510, 30, 8),
        _bwd("_PackedHashEncodeBackward", 550, 50, 7),
        _bwd("torch::autograd::AccumulateGrad", 610, 10, None),
        _launch(15, 1), _kernel(20, 10, 1),
        _launch(45, 2), _kernel(50, 5, 2),
        _launch(215, 3), _kernel(220, 20, 3),
        _launch(280, 4), _kernel(280, 5, 4),
        _launch(315, 5), _kernel(320, 30, 5),
        _launch(375, 6), _kernel(380, 10, 6),
        _launch(520, 7, tid=2), _kernel(520, 16, 7),
        _launch(560, 8, tid=2), _kernel(560, 40, 8),
        _launch(612, 9, tid=2), _kernel(612, 2, 9),
        _launch(760, 10), _kernel(760, 30, 10),
        _launch(950, 11), _kernel(950, 10, 11),
    ]


@pytest.fixture
def reduced():
    return program_spans.reduce(trace.Trace(step_trace(),
                                            "portbench.window"))


def _us(x):
    return x * 1e6


def test_forward_goes_to_the_innermost_span(reduced):
    s = reduced["spans"]
    assert math.isclose(_us(s["ngp.march"]["fwd_s"]), 20)
    assert math.isclose(_us(s["ngp.encoder"]["fwd_s"]), 30)
    assert math.isclose(_us(s["ngp.mlp"]["fwd_s"]), 10)
    assert math.isclose(_us(s["ngp.adam"]["fwd_s"]), 30)
    assert math.isclose(_us(s["ngp.train.step"]["fwd_s"]), 5)
    assert math.isclose(_us(reduced["outside_s"]), 10)
    assert s["ngp.encoder"]["calls"] == 2
    assert s["ngp.train.step"]["calls"] == 1


def test_grid_update_holds_what_it_calls(reduced):
    s = reduced["spans"]
    assert math.isclose(_us(s["ngp.grid_update"]["fwd_s"]), 15)
    assert math.isclose(_us(s["ngp.grid_update"]["total_s"]), 15)


def test_backward_follows_the_sequence_number(reduced):
    s = reduced["spans"]
    assert math.isclose(_us(s["ngp.mlp"]["bwd_s"]), 16)
    assert math.isclose(_us(s["ngp.encoder"]["bwd_s"]), 40)
    # AccumulateGrad has no forward op: the main thread's span at the time
    assert math.isclose(_us(s["ngp.train.step"]["bwd_s"]), 2)
    assert math.isclose(_us(s["ngp.train.step"]["total_s"]), 153)


def test_idle_gaps_go_to_the_span_at_their_midpoint(reduced):
    s = reduced["spans"]
    # gaps 0-20 and 30-50 inside the grid update
    assert math.isclose(_us(s["ngp.grid_update"]["idle_s"]), 40)
    # 55-220 (midpoint 137.5) and 960-1000 lie outside every span
    assert math.isclose(_us(reduced["outside_idle_s"]), 165 + 40)
    total = sum(v["idle_s"] for v in s.values()) + reduced["outside_idle_s"]
    assert math.isclose(_us(total), 1000 - 178)


def test_coverage_is_the_layer_spans_share_of_busy(reduced):
    assert math.isclose(_us(reduced["busy_s"]), 178)
    assert math.isclose(_us(reduced["layer_s"]), 178 - 7 - 10)
    assert math.isclose(reduced["coverage"], 161 / 178)


def test_a_program_without_spans_reads_nothing():
    events = [e for e in step_trace() if not e["name"].startswith("ngp.")]
    red = program_spans.reduce(trace.Trace(events, "portbench.window"))
    assert red["spans"] == {} and red["coverage"] is None
    assert math.isclose(_us(red["outside_s"]), 178)


def test_span_table_per_step():
    sys.path.insert(0, str(ROOT / "portbench"))
    import span_table
    t = trace.Trace(step_trace(), "portbench.window")
    out = span_table.table(t, {"field_points": 4}, 2, "step", "cell")
    assert math.isclose(out["spans"]["ngp.encoder"]["bwd_ms"], 0.02)
    assert math.isclose(out["busy_ms"], 0.089)
    assert out["spans"]["ngp.train.step"]["calls"] == 0.5
    assert out["encoder_check"]["range_fwd_ms"] == 0.0


@pytest.fixture
def fresh_counters(monkeypatch):
    """The program's counters from zero (they add up over a process)."""
    from google_nerf_tpu_torch.utils import logging as plog
    monkeypatch.setattr(plog, "_COUNTERS", {})
    return plog


def test_traced_serving_run_reads_the_counter_metrics(fresh_counters):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        harness.T0 = None
        res = harness.execute(ROOT, SERVE_CELL, SEED, 0.5, True,
                              device="cpu", overrides=SERVE)
    finally:
        torch.set_num_threads(n)
    c = fresh_counters.counters()
    # the program counted the traced views only, not the window's
    assert c["views"] == SERVE["traffic"]["trace_views"]
    m = res["metrics"]
    assert m["serve.drain_trips"]["value"] == c["drain_trips"] / c["views"]
    assert m["serve.drain_trips"]["value"] >= 1
    share = m["serve.field_useful_share"]["value"]
    assert 0 < share <= 100


def test_counter_metrics_read_nothing_untraced(fresh_counters):
    cell = harness.Cell(ROOT, SERVE_CELL)
    for name in ("serve.drain_trips", "serve.field_useful_share"):
        assert cell.reader(name).read({"views": 3}) is None
        assert cell.reader(name).read({"trace": {"views": 3}}) is None
