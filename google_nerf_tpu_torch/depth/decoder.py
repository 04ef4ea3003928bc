"""LeReS top-down decoder blocks (FTB / ATA / FFM / AO) and the auxiliary
disparity head (port of google_nerf_tpu/depth/decoder.py; the
reference's `Minist_Test/lib/network_auxi.py` and
`Train/lib/models/network_auxi.py`).

  * FTB (`network_auxi.py:100-144`): 3x3 conv, then a residual
    relu-conv-BN-relu-conv branch (`conv_branch.{1,2,4}`);
  * ATA (`:147-188`): squeeze-excite over the concat of low and high
    features (kept for parity; the decoder does not call it, as the
    reference's commented-out call site `:205`);
  * FFM (`:191-235`): FTB -> add the upper scale -> FTB -> bilinear x2;
  * AO (`:238-281`): conv-BN-relu-conv (`adapt_conv.{0,1,3}`) -> x2 to
    full resolution, one channel;
  * Decoder (`:15-62`): the 1/32 FTB (`conv`) and `conv1`, then FFM at
    1/16, 1/8, 1/4 (`ffm2`, `ffm1`, `ffm0`) and AO (`outconv`); with
    d_latent > 0 the decoder-site cIMLE AdaIN
    (`Train/lib/models/network_auxi.py:319-566`) modulates x32 after
    conv1 and the laterals features[2..0] before their FFMs;
  * AuxiNetV2 (`Train/lib/models/network_auxi.py:126-172`).

Decoder convolutions carry a bias; BatchNorm is flax's (backbones.BatchNorm2d).
NCHW.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from google_nerf_tpu_torch.depth.adain import AdaInMod
from google_nerf_tpu_torch.depth.backbones import BatchNorm2d
from google_nerf_tpu_torch.utils.logging import span

MIDCHANNELS = (256, 256, 256, 512)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW bilinear x`factor` with align_corners=True; a 1x1 map is
    broadcast."""
    b, c, h, w = x.shape
    if h == 1 and w == 1:
        return x.expand(b, c, h * factor, w * factor)
    return F.interpolate(x, size=(h * factor, w * factor), mode="bilinear",
                         align_corners=True)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class FTB(nn.Module):
    """Feature transfer block (`network_auxi.py:100-144`)."""

    def __init__(self, inchannels: int, mid: int):
        super().__init__()
        self.conv1 = _conv3(inchannels, mid)
        self.conv_branch = nn.Sequential(
            nn.ReLU(), _conv3(mid, mid), BatchNorm2d(mid),
            nn.ReLU(), _conv3(mid, mid))

    def forward(self, x):
        x = self.conv1(x)
        return F.relu(x + self.conv_branch(x))


class ATA(nn.Module):
    """Adaptive channel attention (`network_auxi.py:147-188`); low and
    high each have `channels` channels."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(2 * channels, channels // reduction), nn.ReLU(),
            nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, low, high):
        x = torch.cat([low, high], 1).mean(dim=(2, 3))        # squeeze
        return low * self.fc(x)[:, :, None, None] + high


class FFM(nn.Module):
    """Feature fusion module (`network_auxi.py:191-235`)."""

    def __init__(self, inchannels: int, mid: int, out: int,
                 upfactor: int = 2):
        super().__init__()
        self.ftb1 = FTB(inchannels, mid)
        self.ftb2 = FTB(mid, out)
        self.upfactor = upfactor

    def forward(self, low, high):
        x = self.ftb2(self.ftb1(low) + high)
        return upsample_bilinear(x, self.upfactor)


class AO(nn.Module):
    """Adaptive output head (`network_auxi.py:238-281`)."""

    def __init__(self, inchannels: int, out: int = 1, upfactor: int = 2):
        super().__init__()
        self.adapt_conv = nn.Sequential(
            _conv3(inchannels, inchannels // 2),
            BatchNorm2d(inchannels // 2), nn.ReLU(),
            _conv3(inchannels // 2, out))
        self.upfactor = upfactor

    def forward(self, x):
        return upsample_bilinear(self.adapt_conv(x), self.upfactor)


class Decoder(nn.Module):
    """Top-down decoder (`network_auxi.py:15-62`).

    features: the laterals [1/4, 1/8, 1/16, 1/32] of `lateral` channels.
    Returns the full-resolution 1-channel logit; with return_auxi_input
    also the intermediates AuxiNetV2 takes ([x32x, x8, x4, x2])."""

    def __init__(self, lateral: Sequence[int],
                 midchannels: Sequence[int] = MIDCHANNELS,
                 d_latent: int = 0):
        super().__init__()
        mc = tuple(midchannels)
        self.d_latent = d_latent
        self.conv = FTB(lateral[3], mc[3])
        self.conv1 = _conv3(mc[3], mc[2])
        self.ffm2 = FFM(lateral[2], mc[2], mc[2])
        self.ffm1 = FFM(lateral[1], mc[1], mc[1])
        self.ffm0 = FFM(lateral[0], mc[0], mc[0])
        self.outconv = AO(mc[0], 1, 2)
        if d_latent > 0:
            for i, c in enumerate((lateral[0], lateral[1], lateral[2],
                                   mc[2])):
                setattr(self, f"style_mod{i}", AdaInMod(d_latent, c))

    def _style(self, i, h, z):
        if self.d_latent <= 0:
            return h
        return getattr(self, f"style_mod{i}")(h, z)

    def forward(self, features, z=None, return_auxi_input: bool = False):
        with span("depth.decoder"):
            return self._forward(features, z, return_auxi_input)

    def _forward(self, features, z, return_auxi_input):
        x32x = self.conv(features[3])
        x32 = self._style(3, self.conv1(x32x), z)
        x16 = upsample_bilinear(x32, 2)
        x8 = self.ffm2(self._style(2, features[2], z), x16)
        x4 = self.ffm1(self._style(1, features[1], z), x8)
        x2 = self.ffm0(self._style(0, features[0], z), x4)
        x = self.outconv(x2)
        if return_auxi_input:
            return x, [x32x, x8, x4, x2]
        return x


class AuxiNetV2(nn.Module):
    """Auxiliary disparity branch
    (`Train/lib/models/network_auxi.py:126-172`): per-scale FTBs fused
    bottom-up, then an AO head -> 1-channel disparity."""

    def __init__(self, inchannels: Sequence[int] = (512, 256, 256, 256),
                 mid: int = 256):
        super().__init__()
        self.ftb32 = FTB(inchannels[0], mid)
        self.ftb8 = FTB(inchannels[1], mid)
        self.ftb4 = FTB(inchannels[2], mid)
        self.ftb2 = FTB(inchannels[3], mid)
        self.out = AO(mid, 1, 2)

    def forward(self, auxi_input):
        with span("depth.decoder"):
            return self._forward(auxi_input)

    def _forward(self, auxi_input):
        x32, x8, x4, x2 = auxi_input
        x = upsample_bilinear(self.ftb32(x32), 4) + self.ftb8(x8)
        x = upsample_bilinear(x, 2) + self.ftb4(x4)
        x = upsample_bilinear(x, 2) + self.ftb2(x2)
        return self.out(x)
