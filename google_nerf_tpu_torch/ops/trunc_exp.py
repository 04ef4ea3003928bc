"""Truncated-exponential density activation (port of
google_nerf_tpu/ops/trunc_exp.py): the forward is exp(x); the backward
multiplies by exp(clip(x, -15, 15)), so huge densities cannot blow up
the gradient."""
import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
