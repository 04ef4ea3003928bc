"""priors.device_idle_share: 1 - (union of device kernel, memcpy and
memset intervals) / the profiled slice's wall time, in %."""


def read(run):
    t = run.get("trace")
    if not t or "frames" not in t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
