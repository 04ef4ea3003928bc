"""priors.encoder_roofline: the encoder's operations (stem and stages,
2 x multiply-adds, lib/depth_work.py) over the f32 peak, over the
device time of `depth.encoder`'s own kernels (the AdaIN points' are
`depth.adain`'s) in the profiled slice, in %."""
from portbench.lib.depth_readers import roofline


def read(run):
    return roofline(run, "depth.encoder", flops=2.0 * run.get(
        "work", {}).get("encoder_macs", 0))
