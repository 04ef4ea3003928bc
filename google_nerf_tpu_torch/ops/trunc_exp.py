"""Truncated-exponential density activation, forward only (port of
google_nerf_tpu/ops/trunc_exp.py; the clamped-gradient backward arrives
with the training slice)."""
import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)
