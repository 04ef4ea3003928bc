"""The plain version of the depth decoder's 3x3 convolution: stride 1,
zero padding 1, NCHW float32, weights (Cout, Cin, 3, 3) and a bias.
ops/cuda/conv3x3's kernels compute the same function on the card; this
is what the wrapper runs on CPU tensors, and what the card tests and
chip_smoke hold the kernels to.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F


def _pair_is_one(v) -> bool:
    return tuple(v) == (1, 1) if isinstance(v, (tuple, list)) else v == 1


def check(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], stride=1, padding=1):
    """Raise unless x is a contiguous (B, Cin, H, W) float32, weight a
    contiguous (Cout, Cin, 3, 3) float32 and bias None or a contiguous
    (Cout,) float32, all on one device, with stride and padding 1."""
    if not _pair_is_one(stride) or not _pair_is_one(padding):
        raise ValueError(f"stride {stride}, padding {padding}: the 3x3 "
                         "convolution takes stride 1 and padding 1 only")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is None and name == "bias":
            continue
        if not torch.is_tensor(t) or t.dtype != torch.float32:
            raise TypeError(f"{name}: expected a float32 tensor")
        if not t.is_contiguous():
            raise TypeError(f"{name}: expected a contiguous (NCHW) tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x of shape {tuple(x.shape)}: expected (B, C, H, W)")
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"weight of shape {tuple(weight.shape)}: expected "
                         f"(Cout, {x.shape[1]}, 3, 3)")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias of shape {tuple(bias.shape)}: expected "
                         f"({weight.shape[0]},)")


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride=1,
                  padding=1) -> torch.Tensor:
    """(B, Cout, H, W) = bias + the 3x3 convolution of x, zero outside
    the map."""
    check(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride=1, padding=1)
