"""The port's spans and counters (utils/logging.span, count, counters)
on the CPU, at a toy size: a packed and a hash training step and a
one-shot drain view under torch.profiler.

Every span of the step and of the view appears, nested under its root
(the grid update's under ngp.grid_update, which run_training calls
before the step); the backward nodes of the encoder's Function, of the
MLPs' matmuls and of the pack map, by the sequence number the profiler
records, to forward ops inside ngp.encoder, ngp.mlp and ngp.pack; the
counters count the field's rows, the drain's trips and the views; with
no profiler recording a span is the shared null context and no counter
moves; and the loss, the gradients and the frame are bitwise the same
with and without a profiler recording.
"""
import contextlib
import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from google_nerf_tpu_torch.core.rays import get_ray_directions, get_rays
from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
from google_nerf_tpu_torch.models import ngp as tngp
from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp
from google_nerf_tpu_torch.models.render_test_oneshot import \
    render_test_oneshot
from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
from google_nerf_tpu_torch.train import system as tsys
from google_nerf_tpu_torch.utils import logging as tlog

MODELS = dict(packed=dict(encoder="packed", packed_levels=2,
                          packed_log2_size=8),
              hash=dict(encoder="hash", num_levels=2, log2_hashmap_size=8))
STEP_SPANS = {"ngp.march", "ngp.pack", "ngp.encoder", "ngp.mlp",
              "ngp.composite", "ngp.adam"}
VIEW_SPANS = {"ngp.serve.scan", "ngp.serve.trip", "ngp.march",
              "ngp.encoder", "ngp.mlp", "ngp.composite"}
ENCODE_NODE = dict(packed="_PackedHashEncodeBackward",
                   hash="_BatchedTableGatherBackward")
SERVE = dict(k=32, max_samples=64, T_threshold=0.01, budget_div=0,
             straggler_div=2, drain=True, march="block2", compact_main=True,
             chunk=512)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def train_config(encoder, **over):
    return tsys.TrainConfig(
        model=NGPConfig(scale=0.5, grid_size=16, **MODELS[encoder]),
        batch_size=128, k_samples=64, max_samples=64, samples_budget=1024,
        grid_sample_div=16, random_bg=True, exclude_incomplete="backfill",
        march="block2", grid_update_interval=4, warmup_steps=8, **over)


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticDataset(split="train", n_images=4, img_wh=(24, 24),
                          style="textured", device="cpu")
    return ds, ds.scene()


def trained(scene, encoder, **over):
    """A state after 8 steps (two grid updates), its config and a
    generator; the next step runs a grid update first."""
    ds, sc = scene
    cfg = train_config(encoder, **over)
    state = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    tsys.run_training(state, sc, cfg, steps=8, generator=gen)
    return state, cfg, gen


def traced(fn, tmp_path):
    """fn() under the profiler: its result, the trace's complete events
    and the counters' change."""
    before = tlog.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    after = tlog.counters()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return out, events, moved


def _iv(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))


def holders(events, e):
    """The ngp.* spans on e's thread that hold e's start, innermost
    first."""
    t = float(e["ts"])
    got = [s for s in events if s["name"].startswith("ngp.")
           and s.get("tid") == e.get("tid") and s is not e
           and _iv(s)[0] <= t <= _iv(s)[1]]
    return [s["name"] for s in sorted(got, key=lambda s: -_iv(s)[0])]


def spans_named(events, name):
    return [e for e in events if e["name"] == name]


def forward_span(events, node):
    """The innermost ngp.* span of the forward op that made the backward
    node `node` (the last op to start with its sequence number)."""
    seqs = {e["args"]["Sequence number"] for e in events
            if e["name"] == f"autograd::engine::evaluate_function: {node}"}
    assert seqs, node
    spans = set()
    for seq in seqs:
        fwd = [e for e in events if e.get("cat") == "cpu_op"
               and (e.get("args") or {}).get("Sequence number") == seq
               and not e["args"].get("Fwd thread id")]
        op = max(fwd, key=lambda e: float(e["ts"]))
        spans.add(holders(events, op)[0])
    return spans


@pytest.mark.parametrize("encoder", ["packed", "hash"])
def test_step_spans_nest_under_their_root(scene, encoder, tmp_path):
    state, cfg, gen = trained(scene, encoder)
    _, ev, moved = traced(lambda: tsys.run_training(
        state, scene[1], cfg, steps=2, generator=gen), tmp_path)
    names = {e["name"] for e in ev if e["name"].startswith("ngp.")}
    assert names == STEP_SPANS | {"ngp.train.step", "ngp.grid_update"}
    assert len(spans_named(ev, "ngp.train.step")) == 2
    assert len(spans_named(ev, "ngp.grid_update")) == 1
    for e in ev:
        if e["name"] in STEP_SPANS:
            outer = holders(ev, e)
            assert outer[-1] in ("ngp.train.step", "ngp.grid_update"), (
                e["name"], outer)
            if outer[-1] == "ngp.grid_update":
                assert e["name"] in ("ngp.encoder", "ngp.mlp")
    for root in spans_named(ev, "ngp.train.step"):
        assert holders(ev, root) == []
    assert set(moved) == {"field_points"}


@pytest.mark.parametrize("encoder", ["packed", "hash"])
def test_backward_maps_to_the_forward_span(scene, encoder, tmp_path):
    state, cfg, gen = trained(scene, encoder)
    _, ev, _ = traced(lambda: tsys.fused_train_step(
        state, scene[1], cfg, generator=gen), tmp_path)
    assert forward_span(ev, ENCODE_NODE[encoder]) == {"ngp.encoder"}
    assert forward_span(ev, "MmBackward0") == {"ngp.mlp"}
    assert forward_span(ev, "_TruncExpBackward") == {"ngp.mlp"}


def test_pack_backward_maps_to_the_pack(scene, tmp_path):
    """With the pose refinement the samples' positions carry a gradient,
    so the pack has a backward node."""
    state, cfg, gen = trained(scene, "packed", optimize_ext=True)
    _, ev, _ = traced(lambda: tsys.fused_train_step(
        state, scene[1], cfg, generator=gen), tmp_path)
    assert forward_span(ev, "_PackBackward") == {"ngp.pack"}


def test_field_points_counts_the_rows_evaluated(scene, tmp_path,
                                                monkeypatch):
    state, cfg, gen = trained(scene, "packed")
    rows = []
    enc = tngp._encode_xyz

    def counting(params, c, x01):
        rows.append(x01.shape[0])
        return enc(params, c, x01)

    monkeypatch.setattr(tngp, "_encode_xyz", counting)
    _, _, moved = traced(lambda: tsys.run_training(
        state, scene[1], cfg, steps=2, generator=gen), tmp_path)
    assert moved == {"field_points": sum(rows)}
    assert sum(rows) > 2 * cfg.samples_budget


@pytest.fixture(scope="module")
def view():
    """A hash field, an occupancy and one 40x40 view's rays."""
    cfg = NGPConfig(scale=0.5, grid_size=16, **MODELS["hash"])
    params = init_ngp(torch.Generator().manual_seed(1), cfg, "cpu")
    with torch.no_grad():
        params["hash_table"].mul_(1e3)
    g = torch.Generator().manual_seed(2)
    occ = torch.rand((1, 16, 16, 16), generator=g) < 0.3
    occ2 = pack_occupancy_block2(occ, max_samples=SERVE["max_samples"],
                                 scale=cfg.scale)
    w = h = 40
    K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)
    dirs = get_ray_directions(h, w, K, device="cpu")
    pose = torch.tensor([[1.0, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 1.2]])
    o, d = get_rays(dirs, pose)
    return params, cfg, occ2, o, d


def test_view_spans_and_counters(view, tmp_path):
    params, cfg, occ2, o, d = view
    out, ev, moved = traced(lambda: render_test_oneshot(
        params, cfg, occ2, o, d, **SERVE), tmp_path)
    names = {e["name"] for e in ev if e["name"].startswith("ngp.")}
    assert names == VIEW_SPANS | {"ngp.serve.view"}
    assert len(spans_named(ev, "ngp.serve.view")) == 1
    assert len(spans_named(ev, "ngp.serve.scan")) == 1
    trips = out["drain_trips"]
    assert trips > 1
    # the last trip span only finds no ray alive
    assert len(spans_named(ev, "ngp.serve.trip")) == trips + 1
    for e in ev:
        if e["name"] in VIEW_SPANS:
            assert holders(ev, e)[-1] == "ngp.serve.view", e["name"]
        if e["name"] in ("ngp.march", "ngp.encoder", "ngp.mlp",
                         "ngp.composite"):
            assert "ngp.serve.trip" in holders(ev, e)
    sr = SERVE["chunk"] // SERVE["straggler_div"]
    assert moved == dict(views=1, drain_trips=trips,
                         field_points=trips * sr * SERVE["k"])


def test_spans_and_counters_are_off_without_a_profiler(scene, view):
    assert not torch.autograd._profiler_enabled()
    a, b = tlog.span("ngp.a"), tlog.span("ngp.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    before = tlog.counters()
    tlog.count("views")
    state, cfg, gen = trained(scene, "hash")
    tsys.run_training(state, scene[1], cfg, steps=1, generator=gen)
    params, ncfg, occ2, o, d = view
    render_test_oneshot(params, ncfg, occ2, o, d, **SERVE)
    assert tlog.counters() == before
    with profile(activities=[ProfilerActivity.CPU]):
        assert tlog.span("ngp.a") is not a
        tlog.count("probe", 2)
    assert tlog.counters()["probe"] == before.get("probe", 0) + 2


@pytest.mark.parametrize("encoder", ["packed", "hash"])
def test_step_is_bitwise_the_same_under_the_profiler(scene, encoder,
                                                     tmp_path):
    state, cfg, gen = trained(scene, encoder)
    sc = scene[1]
    batch = tsys.sample_batch(sc, cfg.batch_size, generator=gen)
    draws = dict(bg=torch.rand((cfg.batch_size, 3), generator=gen),
                 noise=torch.rand((cfg.batch_size,), generator=gen))
    plain = tsys.loss_and_grads(state, sc, batch, cfg, draws=draws)
    traced_, _, _ = traced(lambda: tsys.loss_and_grads(
        state, sc, batch, cfg, draws=draws), tmp_path)
    assert torch.equal(plain[0], traced_[0])
    assert torch.equal(plain[1]["rgb"], traced_[1]["rgb"])
    assert plain[2].keys() == traced_[2].keys()
    for k, g in plain[2].items():
        assert torch.equal(g, traced_[2][k]), k
    # and the whole step, Adam included, from two copies of the state
    twin = copy.deepcopy(state)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    _, m1 = tsys.fused_train_step(state, sc, cfg, generator=g1)
    (_, m2), _, _ = traced(lambda: tsys.fused_train_step(
        twin, sc, cfg, generator=g2), tmp_path)
    assert torch.equal(m1["loss"], m2["loss"])
    for k, p in tsys.param_leaves(state["params"]).items():
        assert torch.equal(p, tsys.param_leaves(twin["params"])[k]), k


def test_view_is_bitwise_the_same_under_the_profiler(view, tmp_path):
    params, cfg, occ2, o, d = view
    plain = render_test_oneshot(params, cfg, occ2, o, d, **SERVE)
    got, _, _ = traced(lambda: render_test_oneshot(
        params, cfg, occ2, o, d, **SERVE), tmp_path)
    for k in ("rgb", "opacity", "depth"):
        assert torch.equal(plain[k], got[k]), k
    assert plain["drain_trips"] == got["drain_trips"]
