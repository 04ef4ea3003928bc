"""What the training metrics read from a run, shared by the metric
files of each field's training cells (metrics/train*.<field>.py and
metrics/train.<field>.*.py): a metric is split by field because the
packed cells' rate follows the host and the hash cells' the device, so
each rate has a bound of its own."""
from __future__ import annotations

from portbench.lib import work


def rays_per_s(run):
    """Every ray of every step completed in the window over the window's
    seconds (the window opens and closes on a synchronise, with none
    between)."""
    if run.get("rays") is None:
        return None
    return run["rays"] / run["window_s"]


def launches_per_step(run):
    """Runtime launch calls (kernels, graphs, async copies and sets) in
    the profiled slice over its steps."""
    t = run.get("trace")
    if not t or not t.get("steps"):
        return None
    return t["launches"] / t["steps"]


def device_idle_share(run):
    """1 - (union of device kernel, memcpy and memset intervals) / the
    profiled slice's wall time, in %."""
    t = run.get("trace")
    if not t or "steps" not in t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def enc_gather_roofline(run):
    """The encoder forward's bound (its rows and indices read once, its
    features written once, at the HBM rate) over the device time of the
    kernels launched inside the encoder's call in the training step
    (grid updates left out), in %."""
    t = run.get("trace")
    if not t or not t.get("enc_fwd_s"):
        return None
    nbytes = t["steps"] * work.encoder_forward_bytes(
        run["spec"], run["samples_per_step"], run["gather"])
    return 100.0 * work.bound_s(nbytes)[0] / t["enc_fwd_s"]


def enc_scatter_roofline(run):
    """The encoder backward's bound (the features' gradient and the
    rows' indices read once, the table gradient written once, at the HBM
    rate) over the device time of the kernels launched from the
    encoder's backward, in %."""
    t = run.get("trace")
    if not t or not t.get("enc_bwd_s"):
        return None
    nbytes = t["steps"] * work.encoder_backward_bytes(
        run["spec"], run["samples_per_step"])
    return 100.0 * work.bound_s(nbytes)[0] / t["enc_bwd_s"]


def train_mfu(run):
    """The window's model operations (both MLPs forward and backward on
    each step's evaluated samples, and the density MLP on each grid
    update's points, counted from the configuration) over the window's
    seconds, over the peak of the compute dtype, in %."""
    if not run.get("flops") or not run.get("steps"):
        return None
    peak = work.peak_flops(run["dtype"], run["tf32"])
    return 100.0 * run["flops"] / run["window_s"] / peak
