"""Plain reference of the depth priors of one frame: the LeReS network
(Yin et al., CVPR 2021; github.com/aim-uofa/AdelaiDepth, `LeReS/`) with
a ResNeXt / ResNet encoder and the LeReS top-down decoder, and the cIMLE
AdaIN points of the fork's `RelDepthModel_cIMLE`
(`AdelaiDepth/LeReS/Train/lib/models/multi_depth_model_auxiv2.py:54`,
`Resnext_torch.py:243-478`), as `Train/tools/eval_scannet.py:335-467`
runs it on a frame.

Everything is `torch.nn.functional` and tensor arithmetic over a state
dict read by name (the published torch names: `encoder_modules.conv1`,
`layerL.B.{conv,bn}{1,2,3}`, `layerL.B.downsample.{0,1}`,
`style_modN.mlp.{0,2,4,6}` with the buffers `mean_shift` and
`var_shift`; `decoder_modules.conv`, `conv1`, `ffm{2,1,0}.ftb{1,2}`,
`outconv.adapt_conv`).  The block counts, groups and widths are read
from the weights' shapes.  Float32 with TF32 off, unless a dtype is
given; one minibatch of hypotheses at a time.

Departures from the published code, each leaving the mathematics as it
is:

- BatchNorm is eval mode, (x - running mean) * weight / sqrt(running
  var + 1e-5) + bias, written out.
- The resizes take cv2.resize's INTER_LINEAR sample positions (src =
  (dst + 0.5) * in / out - 0.5, clamped to the edge samples), and the
  decoder's bilinear x2 its align_corners=True positions (src = dst *
  (in - 1) / (out - 1)), both as products with two-tap interpolation
  matrices, rows then columns; cv2 and torch's interpolation are not
  called.  A 1x1 map is broadcast.
- The ATA attention is not called: the published decoder's call is
  commented out (`network_auxi.py:205`).
- The auxiliary disparity branch is not computed: the priors do not
  read it.
- Only the encoder site of the AdaIN points (after the stem convolution,
  before its BatchNorm, and after stages 1-3) is held: a state dict with
  decoder-site points is refused.

The priors of a frame: the frame resized to the crop square, ImageNet
normalisation (`test_depth.py:31-33`), the forward on each minibatch of
latents, each minibatch shifted by its own minimum (logit - min + 0.01,
`multi_depth_model_woauxi.py:16-21`, `eval_scannet.py:374-380`), and
every hypothesis resized back to the frame's size.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
MINIBATCH = 5
ENC = "encoder_modules."
DEC = "decoder_modules."


@contextlib.contextmanager
def no_tf32():
    """cuDNN and cuBLAS without TF32 inside the block."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    was = mm.allow_tf32, cd.allow_tf32
    mm.allow_tf32 = cd.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cd.allow_tf32 = was


def interp_matrix(n_in: int, n_out: int, align_corners: bool,
                  dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(n_out, n_in): each output sample as two taps of the input, at
    cv2 INTER_LINEAR's positions or at align_corners=True's."""
    dst = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = dst * ((n_in - 1) / (n_out - 1)) if n_out > 1 else dst * 0
    else:
        src = (dst + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = src - i0
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), i0), 1.0 - frac)
    np.add.at(m, (np.arange(n_out), i1), frac)
    return torch.as_tensor(m, dtype=dtype, device=device)


def resize(x: torch.Tensor, h: int, w: int, align_corners: bool = False):
    """(..., H, W) -> (..., h, w): along the rows, then the columns."""
    H, W = x.shape[-2:]
    if (H, W) == (1, 1):
        return x.expand(*x.shape[:-2], h, w)
    my = interp_matrix(H, h, align_corners, x.dtype, x.device)
    mx = interp_matrix(W, w, align_corners, x.dtype, x.device)
    x = torch.matmul(x.transpose(-1, -2), my.t()).transpose(-1, -2)
    return torch.matmul(x, mx.t())


class Net:
    """The network over a state dict, in `dtype`."""

    def __init__(self, sd: Dict[str, torch.Tensor], dtype=torch.float32):
        self.sd = {k: (v.to(dtype) if v.is_floating_point() else v)
                   for k, v in sd.items()}
        if any(k.startswith(DEC + "style_mod") for k in sd):
            raise ValueError("decoder-site AdaIN points are not held")
        self.dtype = dtype
        self.stages = [sorted({int(k.split(".")[2]) for k in sd
                               if k.startswith(f"{ENC}layer{s}.")})
                       for s in range(1, 5)]
        self.latent = f"{ENC}style_mod0.mlp.0.weight" in sd

    def w(self, name):
        return self.sd[name]

    def conv(self, x, p, stride=1, bias=False):
        wt = self.w(p + ".weight")
        groups = x.shape[1] // wt.shape[1]
        return F.conv2d(x, wt, self.sd[p + ".bias"] if bias else None,
                        stride, wt.shape[-1] // 2, 1, groups)

    def bn(self, x, p):
        scale = self.w(p + ".weight") * torch.rsqrt(
            self.w(p + ".running_var") + 1e-5)
        return ((x - self.w(p + ".running_mean")[:, None, None])
                * scale[:, None, None] + self.w(p + ".bias")[:, None, None])

    def adain(self, x, z, p):
        """x * (scale + 1 - var_shift) + (shift - mean_shift), scale and
        shift from the LeakyReLU(0.01) MLP of z."""
        h = z
        for i in (0, 2, 4, 6):
            h = F.linear(h, self.w(f"{p}.mlp.{i}.weight"),
                         self.w(f"{p}.mlp.{i}.bias"))
            if i < 6:
                h = F.leaky_relu(h, 0.01)
        scale, shift = h[:, :x.shape[1]], h[:, x.shape[1]:]
        var = scale + 1.0 - self.w(p + ".var_shift")
        mean = shift - self.w(p + ".mean_shift")
        return x * var[:, :, None, None] + mean[:, :, None, None]

    def bottleneck(self, x, p, stride):
        out = F.relu(self.bn(self.conv(x, p + ".conv1"), p + ".bn1"))
        out = F.relu(self.bn(self.conv(out, p + ".conv2", stride),
                             p + ".bn2"))
        out = self.bn(self.conv(out, p + ".conv3"), p + ".bn3")
        if p + ".downsample.0.weight" in self.sd:
            x = self.bn(self.conv(x, p + ".downsample.0", stride),
                        p + ".downsample.1")
        return F.relu(out + x)

    def encoder(self, x, z):
        x = self.conv(x, ENC + "conv1", 2)
        if self.latent:
            x = self.adain(x, z, ENC + "style_mod0")
        x = F.relu(self.bn(x, ENC + "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for s, blocks in enumerate(self.stages):
            for b in blocks:
                x = self.bottleneck(x, f"{ENC}layer{s + 1}.{b}",
                                    2 if s > 0 and b == 0 else 1)
            if self.latent and s < 3:
                x = self.adain(x, z, f"{ENC}style_mod{s + 1}")
            feats.append(x)
        return feats

    def ftb(self, x, p):
        x = self.conv(x, p + ".conv1", bias=True)
        b = self.conv(F.relu(x), p + ".conv_branch.1", bias=True)
        b = F.relu(self.bn(b, p + ".conv_branch.2"))
        b = self.conv(b, p + ".conv_branch.4", bias=True)
        return F.relu(x + b)

    def ffm(self, low, high, p):
        x = self.ftb(self.ftb(low, p + ".ftb1") + high, p + ".ftb2")
        return up2(x)

    def decoder(self, f):
        x = self.conv(self.ftb(f[3], DEC + "conv"), DEC + "conv1",
                      bias=True)
        x = self.ffm(f[2], up2(x), DEC + "ffm2")
        x = self.ffm(f[1], x, DEC + "ffm1")
        x = self.ffm(f[0], x, DEC + "ffm0")
        p = DEC + "outconv.adapt_conv"
        x = F.relu(self.bn(self.conv(x, p + ".0", bias=True), p + ".1"))
        return up2(self.conv(x, p + ".3", bias=True))

    def logit(self, rgb, z):
        """(B, 3, H, W) normalised -> (B, 1, H, W)."""
        return self.decoder(self.encoder(rgb, z))


def up2(x):
    return resize(x, 2 * x.shape[-2], 2 * x.shape[-1], align_corners=True)


@torch.no_grad()
def frame_priors(sd: Dict[str, torch.Tensor], rgb01: torch.Tensor,
                 latents: Optional[torch.Tensor], crop: int,
                 out_hw: Tuple[int, int], *, minibatch: int = MINIBATCH,
                 dtype=torch.float32) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] -> (n_z, h, w) float32 priors, on
    rgb01's device; latents (n_z, d_latent)."""
    net = Net(sd, dtype)
    dev = rgb01.device
    mean = torch.tensor(RGB_MEAN, dtype=dtype, device=dev)[:, None, None]
    std = torch.tensor(RGB_STD, dtype=dtype, device=dev)[:, None, None]
    with no_tf32():
        x = resize(rgb01.to(dtype).permute(2, 0, 1), crop, crop)
        x = ((x - mean) / std)[None]
        out = []
        for s in range(0, latents.shape[0], minibatch):
            z = latents[s:s + minibatch].to(dtype)
            logit = net.logit(x.expand(z.shape[0], -1, -1, -1), z)[:, 0]
            out.append(resize(logit - logit.min() + 0.01, *out_hw).float())
    return torch.cat(out)
