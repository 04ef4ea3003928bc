"""priors.mfu: the multiply-adds of a frame (lib/depth_work.py, counted
from the configuration's published shapes) x 2 x the frames completed in
the window, over the window's seconds, over the peak of the compute
dtype, in %."""
from portbench.lib import work


def read(run):
    if not run.get("views") or not run.get("work"):
        return None
    flops = 2.0 * run["work"]["macs"] * run["views"]
    peak = work.peak_flops(run["dtype"], run["tf32"])
    return 100.0 * flops / run["window_s"] / peak
