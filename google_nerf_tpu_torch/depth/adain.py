"""AdaIN latent-code modulation for cIMLE depth models (port of
google_nerf_tpu/depth/adain.py; the reference's style modules,
`Train/lib/models/Resnext_torch.py:243-330`).

  * `EqualizedDense`: a linear layer with an equalized learning rate
    (StyleGAN's convention: weights ~N(0, init_std^2) scaled at call time
    by w_mul);
  * `StyleMod`: latent -> per-channel (scale, shift) through one
    equalized linear, applied as x * (scale + 1) + shift;
  * `AdaInMod`: latent -> per-channel (scale, shift) through a 4-layer
    LeakyReLU(0.01) MLP (d -> 512 -> 256 -> 128 -> 2C, `mlp.{0,2,4,6}`),
    applied as x * (scale + 1 - var_shift) + (shift - mean_shift).  The
    calibration shifts are registered buffers (zero until
    `model.set_mean_var_shifts` writes them), so they checkpoint with the
    weights as flax's "adain_stats" collection does.

Activations are NCHW: the channel axis is 1.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, C) -> (B, C, 1, ...) against an ndim-D activation."""
    return v.reshape(v.shape + (1,) * (ndim - 2))


class EqualizedDense(nn.Module):
    def __init__(self, in_dim: int, features: int, gain: float = 2.0 ** 0.5,
                 use_wscale: bool = False, lrmul: float = 1.0):
        super().__init__()
        he_std = gain * in_dim ** (-0.5)
        if use_wscale:
            self.init_std, self.w_mul = 1.0 / lrmul, he_std * lrmul
        else:
            self.init_std, self.w_mul = he_std / lrmul, lrmul
        self.lrmul = lrmul
        self.weight = nn.Parameter(torch.empty(features, in_dim))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.weight, std=self.init_std)

    def forward(self, x):
        return F.linear(x, self.weight * self.w_mul, self.bias * self.lrmul)


class StyleMod(nn.Module):
    """Single-linear style modulation (`Resnext_torch.py:269-283`)."""

    def __init__(self, d_latent: int, channels: int, use_wscale: bool = False):
        super().__init__()
        self.lin = EqualizedDense(d_latent, channels * 2, gain=1.0,
                                  use_wscale=use_wscale)

    def forward(self, x, z):
        scale, shift = self.lin(z).chunk(2, dim=-1)
        return x * (_per_channel(scale, x.ndim) + 1.0) \
            + _per_channel(shift, x.ndim)


class AdaInMod(nn.Module):
    """MLP-style AdaIN with calibratable mean/var shifts.
    x: (B, C, ...) activations; z: (B, d_latent)."""

    def __init__(self, d_latent: int, channels: int):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Linear(d_latent, 512), nn.LeakyReLU(0.01),
            nn.Linear(512, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, 128), nn.LeakyReLU(0.01),
            nn.Linear(128, channels * 2))
        self.register_buffer("mean_shift", torch.zeros(channels))
        self.register_buffer("var_shift", torch.zeros(channels))

    def forward(self, x, z):
        scale, shift = self.mlp(z).chunk(2, dim=-1)
        st = (1, -1) + (1,) * (x.ndim - 2)
        var = _per_channel(scale, x.ndim) + 1.0 - self.var_shift.reshape(st)
        mean = _per_channel(shift, x.ndim) - self.mean_shift.reshape(st)
        return x * var + mean
