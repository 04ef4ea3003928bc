"""LeReS depth models: plain, auxiliary-branch and cIMLE (port of
google_nerf_tpu/depth/model.py; the reference's
`Minist_Test/lib/multi_depth_model_woauxi.py:7-34` and
`Train/lib/models/multi_depth_model_auxiv2.py:480-563`).

`DepthNet` is an nn.Module holding `encoder_modules` (LateralEncoder),
`decoder_modules` (Decoder) and, with_auxi, `auxi_modules` (AuxiNetV2):
the reference's torch names, so that its checkpoints load by name
(depth/weights.py).  Images are NCHW.  The forward computes in float32
with TF32 off (`exact_f32`), as JAX's float32 reference does: cuDNN's
convolutions would otherwise take TF32 on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from google_nerf_tpu_torch.depth.adain import AdaInMod, EqualizedDense
from google_nerf_tpu_torch.depth.backbones import (LateralEncoder,
                                                   lateral_channels)
from google_nerf_tpu_torch.depth.decoder import AuxiNetV2, Decoder

# ImageNet normalisation of every LeReS CLI
# (`Minist_Test/tools/test_depth.py:31-33`)
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DepthModelConfig:
    backbone: str = "resnext101_32x8d"   # or resnet50 (test CLIs) etc.
    d_latent: int = 0                    # >0 enables cIMLE
    cimle_site: str = "encoder"          # "encoder" (v2) | "decoder" (v3+)
    with_auxi: bool = False              # train-time disparity branch


class DepthNet(nn.Module):
    """Encoder laterals -> decoder logit (+ optional auxi disparity)."""

    def __init__(self, cfg: DepthModelConfig = DepthModelConfig()):
        super().__init__()
        if cfg.cimle_site not in ("encoder", "decoder"):
            raise ValueError(f"cimle_site {cfg.cimle_site!r}: 'encoder' or "
                             "'decoder'")
        self.cfg = cfg
        enc_latent = cfg.d_latent if cfg.cimle_site == "encoder" else 0
        dec_latent = cfg.d_latent if cfg.cimle_site == "decoder" else 0
        self.encoder_modules = LateralEncoder(cfg.backbone, enc_latent)
        self.decoder_modules = Decoder(lateral_channels(cfg.backbone),
                                       d_latent=dec_latent)
        if cfg.with_auxi:
            self.auxi_modules = AuxiNetV2()

    def forward(self, rgb, z=None, return_adain_acts: bool = False):
        """rgb: (B, 3, H, W) normalised -> (B, 1, H, W) logit, or
        (logit, auxi) with_auxi; with return_adain_acts also the encoder's
        AdaIN activations (None at the decoder site)."""
        enc = self.encoder_modules
        if enc.d_latent:
            feats, acts = enc(rgb, z, return_adain_acts=True)
        else:
            feats, acts = enc(rgb), None
        if self.cfg.with_auxi:
            logit, auxi_in = self.decoder_modules(feats, z,
                                                  return_auxi_input=True)
            out = (logit, self.auxi_modules(auxi_in))
        else:
            out = self.decoder_modules(feats, z)
        if return_adain_acts:
            return out, acts
        return out


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator):
    """flax's default kernel init: variance 1/fan_in, a normal truncated
    at two standard deviations, drawn by its inverse CDF."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    edge = math.erf(2.0 / math.sqrt(2.0))
    w.uniform_(-edge, edge, generator=generator).erfinv_()
    w.mul_(std * math.sqrt(2.0))


@torch.no_grad()
def init_depth_model(generator: torch.Generator, cfg: DepthModelConfig,
                     device="cuda") -> DepthNet:
    """A DepthNet in eval mode with its weights drawn from `generator` as
    flax initialises them (lecun-normal kernels, zero biases, BatchNorm
    scale 1 with running mean 0 and variance 1, zero AdaIN shifts), then
    moved to `device`.  The draws run on the generator's device."""
    gdev = generator.device
    with torch.device("meta"):
        model = DepthNet(cfg)
    model.to_empty(device=gdev)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.reset_running_stats()
        elif isinstance(m, EqualizedDense):
            nn.init.normal_(m.weight, std=m.init_std, generator=generator)
            m.bias.zero_()
        elif isinstance(m, AdaInMod):
            m.mean_shift.zero_()
            m.var_shift.zero_()
    return model.to(device).eval()


@contextlib.contextmanager
def exact_f32():
    """cuDNN convolutions and cuBLAS products without TF32 in this scope
    (cuDNN stays on; its other settings are kept)."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = was


def normalize_rgb(rgb01: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) RGB in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(RGB_MEAN, dtype=rgb01.dtype, device=rgb01.device)
    std = torch.tensor(RGB_STD, dtype=rgb01.dtype, device=rgb01.device)
    return (rgb01 - mean[:, None, None]) / std[:, None, None]


@torch.no_grad()
def depth_forward(model: DepthNet, rgb: torch.Tensor,
                  z: Optional[torch.Tensor] = None):
    """Raw logit(s) in eval mode.  rgb: (B, 3, H, W), normalised."""
    with exact_f32():
        return model(rgb, z)


def depth_inference(model: DepthNet, rgb01: torch.Tensor,
                    z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`RelDepthModel.inference` (`multi_depth_model_woauxi.py:16-21`):
    normalise, forward, then depth - depth.min() + 0.01, the minimum over
    the whole batch (the hypotheses of a minibatch share one shift).
    rgb01: (B, 3, H, W) -> (B, 1, H, W)."""
    out = depth_forward(model, normalize_rgb(rgb01), z)
    logit = out[0] if model.cfg.with_auxi else out
    return logit - logit.min() + 0.01


@torch.no_grad()
def get_adain_init_act(model: DepthNet, rgb: torch.Tensor, z: torch.Tensor):
    """The encoder's AdaIN activations for calibration
    (`Train/lib/models/multi_depth_model_auxiv2.py:113-117`); None at the
    decoder site."""
    with exact_f32():
        return model(rgb, z, return_adain_acts=True)[1]


@torch.no_grad()
def set_mean_var_shifts(model: DepthNet, means, variances) -> DepthNet:
    """Write the AdaIN calibration shifts (`Resnext_torch.py:464-476`):
    one (C,) array each per AdaIN point, style_mod0..style_mod3 in
    order.  Updates the model in place and returns it."""
    sites = sorted((n, m) for n, m in model.named_modules()
                   if isinstance(m, AdaInMod))
    if not len(sites) == len(means) == len(variances):
        raise ValueError(f"{len(sites)} AdaIN points, {len(means)} means, "
                         f"{len(variances)} variances")
    for (_, m), mu, var in zip(sites, means, variances):
        m.mean_shift.copy_(torch.as_tensor(mu, dtype=torch.float32))
        m.var_shift.copy_(torch.as_tensor(var, dtype=torch.float32))
    return model
