"""frame_ms: the window's milliseconds over the views completed in it
(a view is complete when its rgb is on the host)."""


def read(run):
    if not run.get("views"):
        return None
    return 1e3 * run["window_s"] / run["views"]
