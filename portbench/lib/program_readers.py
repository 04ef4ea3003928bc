"""What the per-layer metrics read from the program itself: its
counters (google_nerf_tpu_torch/utils/logging.counters).  The program
counts only while a profiler records, and a run profiles only its
traced slice, so in a traced run the counters hold that slice's work.
A program that keeps no counters reads nothing."""
from __future__ import annotations


def program_counters(run):
    """The program's counters after a traced run, or None."""
    if not run.get("trace"):
        return None
    from google_nerf_tpu_torch.utils import logging
    read = getattr(logging, "counters", None)
    return read() if read is not None else None


def drain_trips_per_view(run):
    """The one-shot renderer's drain trips over the views it served."""
    c = program_counters(run)
    if not c or not c.get("views") or "drain_trips" not in c:
        return None
    return c["drain_trips"] / c["views"]


def field_useful_share(run):
    """The samples a view needs, as the reference counts them on the
    checked views (their mean), over the rows the field evaluated a
    view, in %."""
    c = program_counters(run)
    if not c or not c.get("views") or not c.get("field_points") \
            or not run.get("needed_per_view"):
        return None
    return 100.0 * run["needed_per_view"] * c["views"] / c["field_points"]
