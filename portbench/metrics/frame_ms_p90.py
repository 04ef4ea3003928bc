"""frame_ms_p90: the 90th percentile of every view's latency in the
window, from its request to its rgb on the host (nearest rank)."""
import math


def read(run):
    lat = run.get("latencies_s")
    if not lat:
        return None
    s = sorted(lat)
    return 1e3 * s[math.ceil(0.9 * len(s)) - 1]
