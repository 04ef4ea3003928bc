"""What the depth priors' per-layer metrics read from a traced run: a
layer's share of its bound, from the runner's work a frame
(lib/depth_work.py) and its span's own device time (lib/depth_spans.py)
over the profiled slice's frames."""
from __future__ import annotations

from portbench.lib import work


def roofline(run, span: str, flops: float = 0.0, nbytes: float = 0.0):
    """The bound of `flops` and `nbytes` a frame (the larger of bytes at
    the HBM rate and operations at the compute dtype's peak) x the
    slice's frames, over `span`'s own device seconds, in %; None where
    the slice has no such span."""
    t = run.get("trace")
    s = (t or {}).get("spans", {}).get(span)
    if not s or not s["fwd_s"] or not (flops or nbytes):
        return None
    bound = work.bound_s(nbytes * t["frames"], flops * t["frames"],
                         run["dtype"])[0]
    return 100.0 * bound / s["fwd_s"]
