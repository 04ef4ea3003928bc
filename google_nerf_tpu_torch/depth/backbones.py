"""ResNet / ResNeXt lateral encoders of the LeReS depth network (port of
google_nerf_tpu/depth/backbones.py; the reference's
`Minist_Test/lib/Resnet.py:94-199`, `Resnext_torch.py` and the cIMLE
variant `Train/lib/models/Resnext_torch.py:332-478`), written out with
torch.nn: no torchvision.

Module names are the reference's torch names, which its checkpoints
(`res101.pth`) carry: conv1, bn1, layerL.B.{conv,bn}{1,2,3} and
layerL.B.downsample.{0,1}, style_modN.  Encoder convolutions have no
bias; BatchNorm runs on its running statistics at eps 1e-5 (flax's).
The encoder returns the four lateral maps (1/4, 1/8, 1/16, 1/32) the
decoder takes; there is no classification head.  With d_latent > 0 four
AdaIN modulators act after conv1 (before bn1) and after layers 1-3
(`Resnext_torch.py:439-456`).  NCHW throughout.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn
from torch.nn import functional as F

from google_nerf_tpu_torch.depth.adain import AdaInMod


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2,
                     groups=groups, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ConvBN(nn.Sequential):
    """Conv (no bias) then BatchNorm: a block's `downsample`."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1):
        super().__init__(_conv(cin, cout, kernel, stride, groups), _bn(cout))


class BasicBlock(nn.Module):
    """Two 3x3 convs; resnet18/34.  expansion = 1."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample = (ConvBN(inplanes, planes, 1, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped, strided) -> 1x1 with 4x expansion; resnet50+
    and resnext (width int(planes * base_width / 64) * groups)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = (ConvBN(inplanes, planes * 4, 1, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


_ARCHS = {
    # name -> (block, layers, groups, width_per_group)
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
}

# reference encoder aliases (`Minist_Test/lib/network_auxi.py:8-12`)
ENCODER_ALIASES = {
    "resnet50_stride32": "resnet50",
    "resnext101_stride32x8d": "resnext101_32x8d",
}


def arch_of(arch: str):
    """(block, layers, groups, width_per_group) of an arch or alias."""
    return _ARCHS[ENCODER_ALIASES.get(arch, arch)]


class LateralEncoder(nn.Module):
    """Stem + 4 stages -> [1/4, 1/8, 1/16, 1/32] lateral features, with
    the cIMLE AdaIN points when d_latent > 0."""

    def __init__(self, arch: str = "resnext101_32x8d", d_latent: int = 0):
        super().__init__()
        block, layers, groups, base_width = arch_of(arch)
        self.d_latent = d_latent
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(64)
        in_ch = 64
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or in_ch != planes * block.expansion)
                blocks.append(block(in_ch, planes, s, downsample=ds,
                                    groups=groups, base_width=base_width))
                in_ch = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        if d_latent > 0:
            for i, c in enumerate((64,) + lateral_channels(arch)[:3]):
                setattr(self, f"style_mod{i}", AdaInMod(d_latent, c))

    def forward(self, x, z=None, return_adain_acts: bool = False):
        acts = []

        def style(i, h):
            if self.d_latent <= 0:
                return h
            h = getattr(self, f"style_mod{i}")(h, z)
            acts.append(h)
            return h

        x = style(0, self.conv1(x))
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, 2, padding=1)     # pads with -inf
        feats = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage < 3:
                x = style(stage + 1, x)
            feats.append(x)
        if return_adain_acts:
            return feats, acts
        return feats


def lateral_channels(arch: str) -> Sequence[int]:
    block = arch_of(arch)[0]
    return tuple(p * block.expansion for p in (64, 128, 256, 512))
