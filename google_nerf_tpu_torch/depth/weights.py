"""Reference torch checkpoints (`res101.pth`) -> the port's DepthNet
(port of google_nerf_tpu/depth/weights.py).

The port's modules carry the reference's torch names, so a checkpoint
loads by name: no layout change.  The loader takes exactly the keys
that JAX's `convert_torch_state_dict` takes, with its rules
(weights.py:56-118), and reports the keys it skips as JAX does:

  * encoder_modules: conv1, bn1, layerL.B.{conv,bn}N and
    layerL.B.downsample.{0,1} (conv weight/bias; BatchNorm weight, bias,
    running_mean, running_var);
  * decoder_modules: conv1, the 1/32 FTB `conv.{conv1,conv_branch.N}`,
    `ffmK.ftbJ.{conv1,conv_branch.N}` and `outconv.adapt_conv.N`;
  * skipped: the style-mod MLPs and their shifts, num_batches_tracked,
    and every key outside encoder_modules/decoder_modules (the auxi
    branch among them).

A taken key the model does not have (an encoder conv bias; a decoder of
other widths) is left out and reported apart, as JAX's merge_converted
drops it.  One difference by construction: JAX maps `downsample.*` onto
a Bottleneck's ConvBN_3 in every block, so on resnet18/34 (BasicBlock,
whose downsample is ConvBN_2) its merge drops a torchvision checkpoint's
downsample weights; the port loads them by name.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

_PREFIXES = ("module.", "depth_model.", "model.")
_FTB_FIELDS = ("conv1.", "conv_branch.1.", "conv_branch.2.",
               "conv_branch.4.")
_FTB_KIND = ("conv", "conv", "bn", "conv")
_AO_FIELDS = ("adapt_conv.0.", "adapt_conv.1.", "adapt_conv.3.")
_AO_KIND = ("conv", "bn", "conv")
_LEAVES = {"conv": ("weight", "bias"),
           "bn": ("weight", "bias", "running_mean", "running_var")}


def read_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pth -> {key: CPU tensor}: its `depth_model`, `model_state_dict`
    or top level, then `state_dict` where there is one.  Only tensors,
    dicts and plain values are unpickled (weights_only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("depth_model", ckpt.get("model_state_dict", ckpt))
    if "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def strip_prefix(key: str) -> str:
    for p in _PREFIXES:
        if key.startswith(p):
            key = key[len(p):]
    return key


def _field_kind(sub: str, fields, kinds) -> Optional[str]:
    for f, kind in zip(fields, kinds):
        if sub.startswith(f):
            return kind
    return None


def _encoder_kind(rest: str) -> Optional[str]:
    if rest.startswith("conv1."):
        return "conv"
    if rest.startswith("bn1."):
        return "bn"
    m = re.match(r"layer(\d)\.(\d+)\.(.*)", rest)
    if not m:
        return None
    sub = m.group(3)
    if sub.startswith("downsample.0."):
        return "conv"
    if sub.startswith("downsample.1."):
        return "bn"
    m2 = re.match(r"(conv|bn)(\d)\.", sub)
    return m2.group(1) if m2 else None


def _decoder_kind(rest: str) -> Optional[str]:
    m = re.match(r"(conv1|conv|ffm2|ffm1|ffm0|outconv)\.?(.*)", rest)
    if not m:
        return None
    head, sub = m.group(1), m.group(2)
    if head == "conv1":
        return "conv"
    if head == "conv":
        return _field_kind(sub, _FTB_FIELDS, _FTB_KIND)
    if head == "outconv":
        return _field_kind(sub, _AO_FIELDS, _AO_KIND)
    m2 = re.match(r"(ftb1|ftb2)\.(.*)", sub)
    return _field_kind(m2.group(2), _FTB_FIELDS, _FTB_KIND) if m2 else None


def taken_key(key: str) -> Optional[str]:
    """The port's state-dict key a checkpoint key loads into, or None
    where JAX's converter skips it."""
    k = strip_prefix(key)
    if k.startswith("encoder_modules."):
        kind = _encoder_kind(k[len("encoder_modules."):])
    elif k.startswith("decoder_modules."):
        kind = _decoder_kind(k[len("decoder_modules."):])
    else:
        return None
    if kind is None or k.rsplit(".", 1)[-1] not in _LEAVES[kind]:
        return None
    return k


@torch.no_grad()
def load_reference_state(model: torch.nn.Module,
                         state: Dict[str, torch.Tensor]
                         ) -> Tuple[List[str], List[str]]:
    """Copy a reference state dict's taken keys into model.  Returns
    (skipped: the keys JAX's converter skips, unused: taken keys the
    model lacks).  A taken key of another shape than the model's
    raises."""
    own = model.state_dict()
    skipped, unused = [], []
    for key, val in state.items():
        k = taken_key(key)
        if k is None:
            skipped.append(key)
        elif k not in own:
            unused.append(key)
        elif tuple(val.shape) != tuple(own[k].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)}, the model's "
                             f"{k} is {tuple(own[k].shape)}")
        else:
            own[k].copy_(val)
    return skipped, unused


def load_reference_checkpoint(model: torch.nn.Module, path: str
                              ) -> Tuple[List[str], List[str]]:
    """read_torch_checkpoint + load_reference_state."""
    return load_reference_state(model, read_torch_checkpoint(path))


def load_checkpoint(model: torch.nn.Module, path: str) -> str:
    """--load_ckpt of the depth CLIs: a reference .pth loads by name
    (load_reference_checkpoint); any other file is JAX's save_pytree
    .npz (depth_train.py's), carried across whole and loaded strictly.
    Returns a line that says what was loaded."""
    if path.endswith(".pth"):
        skipped, unused = load_reference_checkpoint(model, path)
        return (f"torch ckpt loaded ({len(skipped)} keys skipped, "
                f"{len(unused)} not in the model)")
    from google_nerf_tpu_torch.convert import (depth_state_from_jax,
                                               read_depth_npz)
    model.load_state_dict(depth_state_from_jax(read_depth_npz(path)),
                          strict=True)
    return f"npz ckpt loaded: {path}"
