"""priors.decoder_kernel_share: the multiply-adds of the decoder's 3x3
convolutions that the port's own kernel computed in the profiled slice
(the program's counter `depth_conv3_macs`, counted again by each replay
of a captured forward) over the decoder's multiply-adds of the slice's
frames (lib/depth_work.py), in %; None where the program has no such
counter or it did not move."""


def read(run):
    t = run.get("trace") or {}
    macs = t.get("counters", {}).get("depth_conv3_macs")
    want = run.get("work", {}).get("decoder_macs", 0) * t.get("frames", 0)
    if not macs or not want:
        return None
    return 100.0 * macs / want
