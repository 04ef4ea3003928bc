"""priors.decoder_roofline: the decoder's operations (2 x multiply-adds,
lib/depth_work.py) over the f32 peak, over the device time of
`depth.decoder`'s kernels in the profiled slice, in %."""
from portbench.lib.depth_readers import roofline


def read(run):
    return roofline(run, "depth.decoder", flops=2.0 * run.get(
        "work", {}).get("decoder_macs", 0))
