"""serve_mfu: both MLPs forward on the samples a view needs, as the
plain reference counts them on the checked views (their mean), times
the views of the window, over the window's seconds, over the peak of
the compute dtype, in %."""
from portbench.lib import work


def read(run):
    if not run.get("views") or not run.get("needed_per_view"):
        return None
    flops = run["views"] * work.view_flops(run["spec"],
                                           run["needed_per_view"])
    peak = work.peak_flops(run["dtype"], run["tf32"])
    return 100.0 * flops / run["window_s"] / peak
