"""The work of the depth priors of a frame, counted from a depth
configuration's published shapes (its "published" block and
`model.d_latent`), not from the program's modules, so that it counts
the same work whatever computes it.

Multiply-adds of every convolution (biases left out), of every linear
layer of the AdaIN MLPs, and the bytes of every AdaIN modulation: its
activation read and written once in float32 for each hypothesis, its
MLP's weights and biases and its two calibration shifts read once a
minibatch.  BatchNorm, the ReLUs, the pooling, the upsampling and the
resizes are left out of the operations.  Spatial sizes follow the
convolutions' arithmetic: (n + 2 * (k // 2) - k) // stride + 1.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

F32 = 4


def _out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def _conv(hw: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    return hw * hw * cout * (cin // groups) * k * k


def encoder(pub: Dict, crop: int) -> Tuple[int, List[Tuple[int, int]]]:
    """(MACs a hypothesis of the stem and the four stages, the (channels,
    side) of the stem's output and of each stage's)."""
    stem = pub["stem"]
    s = _out(crop, stem["kernel"], stem["stride"])
    macs = _conv(s, 3, stem["out"], stem["kernel"])
    maps = [(stem["out"], s)]
    s = _out(s, 3, 2)                      # the 3x3 / 2 max pool
    cin = stem["out"]
    for stage, (planes, blocks) in enumerate(zip(pub["planes"],
                                                 pub["layers"])):
        width = planes * pub["width_per_group"] // 64 * pub["groups"]
        cout = planes * pub["expansion"]
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            so = _out(s, 3, stride)
            macs += _conv(s, cin, width, 1)
            macs += _conv(so, width, width, 3, pub["groups"])
            macs += _conv(so, width, cout, 1)
            if b == 0:
                macs += _conv(so, cin, cout, 1)      # downsample
            s, cin = so, cout
        maps.append((cout, s))
    return macs, maps


def decoder(pub: Dict, maps: List[Tuple[int, int]]) -> int:
    """MACs a hypothesis of the LeReS decoder on the four laterals:
    FTB (a 3x3 and a two-conv 3x3 branch) and conv1 at 1/32, three FFMs
    (two FTBs each) at 1/16, 1/8 and 1/4, and the AO head (3x3 to half
    the channels, 3x3 to one) at 1/2."""
    mid = pub["decoder_mid"]
    lat = maps[1:]

    def ftb(side, cin, cout):
        return _conv(side, cin, cout, 3) + 2 * _conv(side, cout, cout, 3)

    (c3, s3) = lat[3]
    macs = ftb(s3, c3, mid[3]) + _conv(s3, mid[3], mid[2], 3)
    for i in (2, 1, 0):
        c, s = lat[i]
        macs += ftb(s, c, mid[i]) + ftb(s, mid[i], mid[i])
    side = 2 * lat[0][1]
    return macs + _conv(side, mid[0], mid[0] // 2, 3) \
        + _conv(side, mid[0] // 2, 1, 3)


def adain_mlp_weights(pub: Dict, d_latent: int, channels: int) -> int:
    """Weights (MACs a hypothesis) of one point's MLP d -> ... -> 2C."""
    dims = [d_latent] + list(pub["adain_mlp"]) + [2 * channels]
    return sum(a * b for a, b in zip(dims, dims[1:]))


def frame_work(conf: Dict, crop: int, n_z: int, minibatch: int) -> Dict:
    """A frame's work: {encoder_macs, decoder_macs, adain_macs, macs,
    adain_elems, adain_bytes}, each for all n_z hypotheses."""
    pub, d = conf["published"], int(conf["model"]["d_latent"])
    enc, maps = encoder(pub, crop)
    dec = decoder(pub, maps)
    calls = math.ceil(n_z / minibatch)
    mlp = elems = nbytes = 0
    if d > 0:
        for c, s in maps[:4]:       # the stem's output, stages 1-3's
            w = adain_mlp_weights(pub, d, c)
            n_bias = sum(pub["adain_mlp"]) + 2 * c
            mlp += w
            elems += c * s * s
            nbytes += calls * F32 * (w + n_bias + 2 * c)
        nbytes += n_z * 2 * F32 * elems
    return dict(encoder_macs=n_z * enc, decoder_macs=n_z * dec,
                adain_macs=n_z * mlp, macs=n_z * (enc + dec + mlp),
                adain_elems=n_z * elems, adain_bytes=nbytes)
