"""serve.launches_per_frame: runtime launch calls (kernels, graphs,
async copies and sets) in the profiled slice over its views."""


def read(run):
    t = run.get("trace")
    if not t or not t.get("views"):
        return None
    return t["launches"] / t["views"]
