"""setup_s: seconds from process start to the window's start (imports,
the kernels' libraries from the build cache, inputs made from the seed,
warm-up)."""


def read(run):
    return run.get("setup_s")
