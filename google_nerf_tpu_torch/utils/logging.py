"""Training telemetry (port of google_nerf_tpu/utils/logging.py):
smoothed stats, scalar logging, profiler hooks, spans and counters, and
the NaN tripwire.

  * SmoothedValue / TrainingStats: median-smoothed windows and an ETA;
  * ScalarLogger: JSONL always (the durable record), TensorBoard too
    when torch.utils.tensorboard imports;
  * profile_trace: a torch.profiler trace of a step range, written as a
    Chrome trace into log_dir;
  * span(name): a profiler range (a cpu_op event of that name) while a
    torch.profiler records, a shared null context otherwise (0.2 us a
    call), so the spans cost nothing when no one traces; count(name, n)
    adds a host integer to a counter under the same gate, counters()
    copies them;
  * debug_mode: torch.autograd.set_detect_anomaly, the port's
    jax_debug_nans.

The spans mark the layers of the NGP training step, of the one-shot
renderer and of the depth priors of a frame; one step's, one view's or
one frame's spans nest under its root on one thread:

  ngp.train.step     train/system.fused_train_step (root)
  ngp.march          the ray clip and the marcher
  ngp.pack           the budget plan, the sample table and its pack
  ngp.encoder        the xyz encoder in models/ngp.ngp_density
  ngp.mlp            the density MLP and trunc_exp; the direction's
                     SH encoding, the colour MLP and the sigmoid
  ngp.composite      the composite, the background and backfill tail
  ngp.adam           train/system.apply_grads
  ngp.grid_update    train/system.grid_update_step, all it calls
  ngp.serve.view     models/render_test_oneshot (root)
  ngp.serve.scan     the compact_main super scan
  ngp.serve.trip     one drain trip, its any-alive read included
  depth.priors.frame depth/priors.frame_priors (root)
  depth.resize       the frame's resize to the crop and its ImageNet
                     normalisation; each minibatch's shift and the
                     priors' resize back
  depth.encoder      depth/backbones.LateralEncoder: stem and stages
  depth.adain        each depth/adain.AdaInMod: its MLP and modulation
  depth.decoder      depth/decoder.Decoder (and AuxiNetV2)

and the counters field_points (rows the field evaluates, each
ngp_density call), drain_trips and views (render_test_oneshot),
depth_frames and depth_hypotheses (frame_priors: a frame, and the rows
of each minibatch's forward).  A
backward kernel belongs to the span of its forward op: the profiler
gives both the same autograd sequence number.  Spans and counters exist
only while a profiler records: no flag, variable or key turns them on.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import torch

# ScalarLogger also writes TensorBoard events when this is on and
# torch.utils.tensorboard imports (it loads TensorFlow where installed)
USE_TENSORBOARD = True


class SmoothedValue:
    """Window median and average, and the global average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.deque.append(v)
        self.series.append(v)
        self.count += 1
        self.total += v

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class ScalarLogger:
    """JSONL + optional TensorBoard scalar sink (rank 0 only)."""

    def __init__(self, log_dir: Optional[str] = None, rank: int = 0):
        self.rank = rank
        self.jsonl = None
        self.tb = None
        if log_dir and rank == 0:
            os.makedirs(log_dir, exist_ok=True)
            self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            if USE_TENSORBOARD:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self.tb = SummaryWriter(log_dir)
                except ImportError:
                    self.tb = None

    def log(self, step: int, scalars: Dict[str, Any]):
        if self.rank != 0:
            return
        if self.jsonl is not None:
            rec = {"step": int(step),
                   **{k: float(v) for k, v in scalars.items()},
                   "time": time.time()}
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class TrainingStats:
    """Median-smoothed per-key stats with an ETA."""

    def __init__(self, total_iters: int, log_interval: int = 10,
                 logger: Optional[ScalarLogger] = None, window: int = 20):
        self.total_iters = total_iters
        self.log_interval = log_interval
        self.logger = logger
        self.smoothed: Dict[str, SmoothedValue] = {}
        self.window = window
        self.iter_start = None
        self.iter_time = SmoothedValue(window)

    def iter_tic(self):
        self.iter_start = time.time()

    def iter_toc(self):
        if self.iter_start is not None:
            self.iter_time.update(time.time() - self.iter_start)

    def update(self, scalars: Dict[str, Any]):
        for k, v in scalars.items():
            self.smoothed.setdefault(
                k, SmoothedValue(self.window)).update(float(v))

    def eta_seconds(self, cur_iter: int) -> float:
        return self.iter_time.median * max(self.total_iters - cur_iter, 0)

    def log_iter_stats(self, cur_iter: int, extra: Optional[Dict] = None,
                       print_fn=print):
        if cur_iter % self.log_interval:
            return
        stats = {k: v.median for k, v in self.smoothed.items()}
        if extra:
            stats.update(extra)
        eta = self.eta_seconds(cur_iter)
        msg = f"[iter {cur_iter}/{self.total_iters} eta {eta:7.0f}s] " + \
            " ".join(f"{k}={v:.4g}" for k, v in stats.items())
        print_fn(msg)
        if self.logger is not None:
            self.logger.log(cur_iter, stats)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A torch.profiler trace (CPU and, where there is one, the card) of
    the enclosed steps, written as trace.json into log_dir."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}
_recording = torch.autograd._profiler_enabled
# a range made in C++, as torch's compiled kernels mark themselves: the
# Python record_function's ranges slowed a traced training step on an
# H100 by 3-6 ms (the launches inside them), this one by none measured
_range = torch._C._profiler._RecordFunctionFast
# while depth/priors.py captures a forward in CUDA graphs: name -> the
# context that ends the graph being captured and begins the next
_cut = None


def span(name: str):
    """A named profiler range while a torch.profiler records, else one
    shared null context.  While a forward is captured in CUDA graphs
    (depth/priors.py), a cut of the capture at the span's two ends, so
    that each replay can run inside the spans its kernels belong to."""
    if _cut is not None:
        return _cut(name)
    if _recording():
        return _range(name)
    return _OFF


def count(name: str, n: int = 1):
    """Add the host integer n to counter `name` while a torch.profiler
    records (never a device value: that would synchronise)."""
    if _recording():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of the counters, {name: total since the process began}."""
    return dict(_COUNTERS)


def debug_mode(nans: bool = True):
    """Turn autograd's anomaly detection on (a NaN in a backward raises
    where it arose) or off."""
    torch.autograd.set_detect_anomaly(bool(nans))
