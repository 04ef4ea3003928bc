"""The depth models' optimizer and learning-rate schedule (port of
google_nerf_tpu/depth/optim.py; the reference's
`Train/lib/models/multi_depth_model_auxiv2.py:359-466`, ModelOptimizer:
SGD with momentum 0.9, weight decay 5e-4, split encoder / decoder /
style-MLP learning rates, a gradient-norm clip of 10; and
`Train/lib/utils/lr_scheduler_custom.py:4-55`, WarmupMultiStepLR).

`DepthSGD` takes the steps of JAX's optax chain, in its order:
  1. the global-norm clip: every gradient times clip / norm when the
     norm of all of them is at least clip (optax's rule, not torch's
     clip / (norm + 1e-6));
  2. weight decay: g + 5e-4 p, on every parameter;
  3. momentum: trace = g + 0.9 trace (the trace starts at zero);
  4. p -= lr_group * schedule(count) * trace, count the number of
     updates before this one (the first reads 0).
A parameter's group is decided by JAX's rule on its flax path, which
convert.depth_flax_path gives for the port's torch name.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

GROUPS = ("encoder", "decoder", "style")


def warmup_multistep_lr(base_lr: float, milestones: Sequence[int],
                        gamma: float = 0.1,
                        warmup_factor: float = 1.0 / 3,
                        warmup_iters: int = 500,
                        warmup_method: str = "linear"
                        ) -> Callable[[int], float]:
    """`WarmupMultiStepLR`: lr(step) = base * warmup(step) * gamma ** (the
    milestones at or before step), warmup linear from warmup_factor or
    constant at it for the first warmup_iters steps.  Computed in
    float32 in JAX's order, so it returns JAX's values."""
    milestones = sorted(milestones)
    f32 = np.float32

    def schedule(step: int) -> float:
        if warmup_method == "constant":
            wf = f32(warmup_factor) if step < warmup_iters else f32(1.0)
        else:
            alpha = min(f32(step) / f32(max(warmup_iters, 1)), f32(1.0))
            wf = (f32(warmup_factor) * (f32(1.0) - alpha) + alpha
                  if step < warmup_iters else f32(1.0))
        n_hit = sum(step >= m for m in milestones)
        return float(f32(base_lr) * wf * np.power(f32(gamma), f32(n_hit)))

    return schedule


def param_group(flax_name: str) -> str:
    """JAX's grouping (`multi_depth_model_auxiv2.py:404-419`) on a
    '/'-joined flax path: 'style' in it -> style; 'encoder' or 'res' ->
    encoder; else decoder."""
    if "style" in flax_name:
        return "style"
    if "encoder" in flax_name or "res" in flax_name:
        return "encoder"
    return "decoder"


def param_groups(model: torch.nn.Module) -> Dict[str, str]:
    """{port parameter name: its group} for a DepthNet."""
    from google_nerf_tpu_torch.convert import (depth_flax_path,
                                               depth_n_convs)
    named = dict(model.named_parameters())
    n_convs = depth_n_convs(named)
    return {k: param_group("/".join(depth_flax_path(k, p.ndim,
                                                    n_convs)[1]))
            for k, p in named.items()}


class DepthSGD(torch.optim.Optimizer):
    """JAX's depth optimizer (module docstring).  One param group per
    group name, each with its base lr ("base_lr"), the shared schedule
    and the update count ("count"); a parameter's state is its momentum
    trace ("trace")."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 groups: Dict[str, str], lrs: Dict[str, float],
                 weight_decay: float = 5e-4, momentum: float = 0.9,
                 clip_norm: float = 10.0,
                 schedule: Optional[Callable[[int], float]] = None):
        param_groups = []
        for g in GROUPS:
            names = [k for k in named_params if groups[k] == g]
            if names:
                param_groups.append(dict(
                    params=[named_params[k] for k in names], names=names,
                    group=g, base_lr=float(lrs[g]), count=0))
        super().__init__(param_groups, dict(weight_decay=weight_decay,
                                            momentum=momentum))
        self.clip_norm = clip_norm
        self.schedule = schedule if schedule is not None else (
            lambda _: 1.0)

    def lr(self, group: str) -> float:
        """The learning rate the next update of `group` takes: its base
        times the schedule at the update count, in float32 (optax's)."""
        g = next(pg for pg in self.param_groups if pg["group"] == group)
        return float(np.float32(g["base_lr"])
                     * np.float32(self.schedule(g["count"])))

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        sq = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for gr in grads:
            sq = sq + (gr * gr).sum()
        norm = torch.sqrt(sq)
        it = iter(grads)
        for group in self.param_groups:
            lr = self.lr(group["group"])
            for p in group["params"]:
                gr = next(it)
                gr = torch.where(norm < self.clip_norm, gr,
                                 gr / norm * self.clip_norm)
                gr = gr + group["weight_decay"] * p
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = gr + group["momentum"] * state["trace"]
                state["trace"] = trace
                p.sub_(lr * trace)
            group["count"] += 1
        return None


def make_depth_optimizer(model: torch.nn.Module, base_lr: float,
                         scale_decoder_lr: float = 1.0,
                         mlp_lr: Optional[float] = None,
                         weight_decay: float = 5e-4, momentum: float = 0.9,
                         clip_norm: float = 10.0,
                         fixed_backbone: bool = False,
                         schedule=None) -> DepthSGD:
    """SGD with per-group learning rates and the global-norm clip over
    a DepthNet's parameters.  schedule: a multiplier schedule(count) for
    every group (warmup_multistep_lr(1.0, ...) for the reference's); a
    frozen backbone gives the encoder and decoder lr 0."""
    mlp_lr = base_lr if mlp_lr is None else mlp_lr
    lrs = {"encoder": 0.0 if fixed_backbone else base_lr,
           "decoder": 0.0 if fixed_backbone else base_lr * scale_decoder_lr,
           "style": mlp_lr}
    return DepthSGD(dict(model.named_parameters()), param_groups(model),
                    lrs, weight_decay=weight_decay, momentum=momentum,
                    clip_norm=clip_norm, schedule=schedule)
