"""ResNet / ResNeXt lateral encoders of the LeReS depth network (port of
google_nerf_tpu/depth/backbones.py; the reference's
`Minist_Test/lib/Resnet.py:94-199`, `Resnext_torch.py` and the cIMLE
variant `Train/lib/models/Resnext_torch.py:332-478`), written out with
torch.nn: no torchvision.

Module names are the reference's torch names, which its checkpoints
(`res101.pth`) carry: conv1, bn1, layerL.B.{conv,bn}{1,2,3} and
layerL.B.downsample.{0,1}, style_modN.  Encoder convolutions have no
bias; BatchNorm is flax's at eps 1e-5 and momentum 0.9 (BatchNorm2d):
its running statistics in eval mode, the batch's in train mode.
The encoder returns the four lateral maps (1/4, 1/8, 1/16, 1/32) the
decoder takes; there is no classification head.  With d_latent > 0 four
AdaIN modulators act after conv1 (before bn1) and after layers 1-3
(`Resnext_torch.py:439-456`).  NCHW throughout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from google_nerf_tpu_torch.depth.adain import AdaInMod
from google_nerf_tpu_torch.parallel.comm import all_reduce_sum
from google_nerf_tpu_torch.utils.logging import span


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2,
                     groups=groups, bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d at eps 1e-5 (its parameters, buffers and state_dict
    keys) whose train-mode forward is flax's nn.BatchNorm at momentum
    0.9: torch's batch_norm normalises the batch by its mean and biased
    variance, and the running statistics take 0.9 of themselves plus 0.1
    of the batch's, the biased variance too (torch's would take the
    unbiased).  Eval mode is torch's, on the running statistics.

    With `axis_name` set (DepthModelConfig.bn_axis_name sets it on every
    BatchNorm of the network; the port's one data axis is the default
    process group), train mode is flax's BatchNorm with that axis_name,
    SyncBN: the statistics of the whole group's batch, from the per-rank
    sums of x and x^2 and the counts all-reduced in one call (count-
    weighted), the variance flax's E[x^2] - E[x]^2 floored at 0.  The
    all-reduce is differentiable: the backward pass sums the statistics'
    gradients over the ranks.  Without a group it is the rank's own
    batch."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)
        self.axis_name: Optional[str] = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.axis_name is not None:
            return self._synced(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
            self._track(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    @torch.no_grad()
    def _track(self, mean, var):
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var)
        self.num_batches_tracked.add_(1)

    def _synced(self, x):
        C = x.shape[1]
        count = torch.full((1,), x.numel() // C, dtype=x.dtype,
                           device=x.device)
        sums = all_reduce_sum(torch.cat([x.sum((0, 2, 3)),
                                         (x * x).sum((0, 2, 3)), count]))
        mean = sums[:C] / sums[-1]
        var = torch.clamp_min(sums[C:2 * C] / sums[-1] - mean * mean, 0.0)
        self._track(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c)


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
        with span("depth.encoder"):
            return self._forward(x, z, return_adain_acts)

    def _forward(self, x, z, return_adain_acts):
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
