"""priors.adain_roofline: the AdaIN points' bound (their activations read
and written once in float32, their MLPs' weights once a minibatch, at
the HBM rate, against the MLPs' and the modulation's operations at the
f32 peak) over the device time of `depth.adain`'s kernels in the
profiled slice, in %."""
from portbench.lib.depth_readers import roofline


def read(run):
    w = run.get("work", {})
    return roofline(run, "depth.adain", nbytes=w.get("adain_bytes", 0),
                    flops=2.0 * w.get("adain_macs", 0)
                    + 2.0 * w.get("adain_elems", 0))
