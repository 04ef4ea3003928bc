"""How far a depth train step in float32 lies from the step in float64.

One train step of the cIMLE depth trainer (trainer.loss_and_grads: the
train-mode forward, depth_losses, the backward pass; then the optimizer)
on seeded inputs.  The exact step is float64 on the CPU; against it, the
float32 step on the CPU and, on a card, the float64 and float32 steps
there: the loss's relative distance, and for the gradients and the
optimizer's momentum traces the global norm-relative distance, the
largest per tensor and the four tensors furthest off, over
compared_keys (every parameter whose gradient is not zero in exact
arithmetic).  On the CPU it also splits the float32 step's error
(`split`): the prediction, the loss's gradient with respect to it, the
losses alone on the exact prediction, and the network's backward pass
alone from the exact gradient, with BatchNorm on the batch and on its
running statistics.  Prints one JSON object a setting.

    python -m google_nerf_tpu_torch.tools.depth_step_precision \\
        --device cuda --setting resnet18:64:2:8 \\
        --setting resnext101_32x8d:448:1:32
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json

import torch

from google_nerf_tpu_torch.depth import trainer
from google_nerf_tpu_torch.depth.config import DepthCfg
from google_nerf_tpu_torch.depth.losses import depth_losses, loss_draws


def inputs(arch: str, hw: int, batch: int, d_latent: int, seed: int = 0):
    """(cfg, model, data, z, draws): a model from `seed`, a smooth depth
    with noise, random normalised colours, latents and loss draws."""
    cfg = DepthCfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=arch, d_latent=d_latent))
    model = trainer.init_trainer(seed, cfg, "cpu")[0].model
    gen = torch.Generator().manual_seed(seed + 1)
    yy, xx = torch.meshgrid(torch.arange(float(hw)), torch.arange(float(hw)),
                            indexing="ij")
    depth = (1.5 + 0.5 * torch.sin(xx / 5) + 0.4 * torch.cos(yy / 7)
             + 0.02 * torch.randn((batch, hw, hw), generator=gen))
    data = dict(rgb=torch.randn((batch, 3, hw, hw), generator=gen),
                depth=depth, disp=1.0 / depth,
                focal_length=torch.full((batch,), 256.0),
                quality_flg=torch.full((batch,), 3, dtype=torch.int32),
                planes=torch.zeros((batch, hw, hw), dtype=torch.int64))
    z = torch.randn((batch, d_latent), generator=gen)
    draws = loss_draws(batch, hw, hw, cfg.train.loss_mode, gen, "cpu")
    return cfg, model, data, z, draws


def step(cfg, model, data, z, draws, device, dtype=torch.float32):
    """One train step of a copy of `model` on `device` in `dtype`: (loss,
    {name: gradient}, {name: the optimizer's momentum trace}), the
    tensors in float64 on the CPU.  The step moves each parameter by its
    group's learning rate (a host number) times its trace."""
    m = copy.deepcopy(model).to(device, dtype)

    def cast(t):
        return t.to(device, dtype) if t.is_floating_point() else t.to(device)

    losses, grads = trainer.loss_and_grads(
        m, {k: cast(v) for k, v in data.items()}, cast(z),
        trainer.loss_config(cfg),
        draws={n: {k: cast(v) for k, v in d.items()}
               for n, d in draws.items()})
    grads = {k: g.detach().double().cpu() for k, g in grads.items()}
    opt = trainer.make_optimizer(m, cfg)
    opt.step()
    return (float(losses["total_loss"].detach()), grads,
            {k: opt.state[p]["trace"].double().cpu()
             for k, p in m.named_parameters()})


def norm_rel(got, want, keys) -> float:
    """||got - want|| / ||want|| over the tensors `keys` of two dicts."""
    num = sum(float((got[k] - want[k]).norm()) ** 2 for k in keys)
    return (num / sum(float(want[k].norm()) ** 2 for k in keys)) ** 0.5


def compared_keys(model, batch: int):
    """Every parameter but those whose gradient is zero in exact
    arithmetic, which float32 leaves as rounding noise that no relative
    bound can hold: trainer.bn_fed_biases, and at a batch of 1 the
    encoder's first AdaIN modulator (style_mod0 scales and shifts conv1's
    output per channel just before bn1, whose batch statistics over one
    image take both out again; the scale's gradient is eps's alone)."""
    skip = set(trainer.bn_fed_biases(model))
    if batch == 1:
        skip |= {k for k, _ in model.named_parameters()
                 if k.startswith("encoder_modules.style_mod0.")}
    return [k for k, _ in model.named_parameters() if k not in skip]


def distances(exact, got, keys):
    """A step's distances from the exact one: the loss relative; for the
    gradients and the traces, norm-relative over `keys`, the largest of
    any one tensor, and the four tensors furthest off."""
    out = dict(loss=abs(got[0] - exact[0]) / abs(exact[0]))
    for i, what in ((1, "grads"), (2, "traces")):
        per = sorted(((norm_rel(got[i], exact[i], [k]), k) for k in keys),
                     reverse=True)
        out[what] = norm_rel(got[i], exact[i], keys)
        out[f"{what}_tensor_max"] = per[0][0]
        out[f"{what}_worst"] = per[:4]
    return out


def compare(cfg, model, data, z, draws, device):
    """The CPU's float32 step and, on a card, its float64 and float32
    steps against the CPU's float64 step (`distances` each: "cpu",
    "card_f64", "card"); "loss_card_vs_cpu", the relative distance of
    the two float32 losses."""
    batch = data["rgb"].shape[0]
    keys = compared_keys(model, batch)
    exact = step(cfg, model, data, z, draws, "cpu", torch.float64)
    cpu = step(cfg, model, data, z, draws, "cpu")
    out = dict(batch=batch, n_compared=len(keys),
               cpu=distances(exact, cpu, keys))
    if torch.device(device).type != "cpu":
        out["card_f64"] = distances(
            exact, step(cfg, model, data, z, draws, device, torch.float64),
            keys)
        card = step(cfg, model, data, z, draws, device)
        out["card"] = distances(exact, card, keys)
        out["loss_card_vs_cpu"] = abs(card[0] - cpu[0]) / abs(cpu[0])
    return out


def _forward(model, data, z, draws, lcfg, dtype):
    """A train-mode forward and backward of a copy of `model` on the CPU
    in `dtype`: (the prediction, dLoss/dprediction)."""
    m = copy.deepcopy(model).to(dtype=dtype).train()

    def cast(t):
        return t.to(dtype=dtype) if t.is_floating_point() else t

    pred = m(cast(data["rgb"]), cast(z))[:, 0]
    pred.retain_grad()
    depth_losses(pred, {k: cast(v) for k, v in data.items()}, lcfg,
                 draws={n: {k: cast(v) for k, v in d.items()}
                        for n, d in draws.items()})["total_loss"].backward()
    return pred.detach().double(), pred.grad.double()


def _backward(model, data, z, upstream, dtype, train):
    """The parameter gradients of a copy of `model` on the CPU in
    `dtype`, its prediction's gradient set to `upstream`; BatchNorm on
    the batch (train) or on its running statistics."""
    m = copy.deepcopy(model).to(dtype=dtype).train(train)
    m(data["rgb"].to(dtype), z.to(dtype))[:, 0].backward(upstream.to(dtype))
    return {k: p.grad.double() for k, p in m.named_parameters()}


def split(cfg, model, data, z, draws):
    """Where the CPU's float32 step leaves float64, norm-relative:
    "pred", the prediction; "dpred", dLoss/dprediction; "losses_alone",
    dLoss/dprediction of the float32 losses on the float64 prediction;
    "backward_alone", the gradients (compared_keys) of a float32 forward
    and backward pass fed the float64 dLoss/dprediction, against the
    same in float64; "backward_alone_bn_eval", the same with BatchNorm on
    its running statistics (an affine map) instead of the batch's."""
    lcfg = trainer.loss_config(cfg)
    p64, g64 = _forward(model, data, z, draws, lcfg, torch.float64)
    p32, g32 = _forward(model, data, z, draws, lcfg, torch.float32)
    pred = p64.float().requires_grad_()
    depth_losses(pred, {k: v.float() if v.is_floating_point() else v
                        for k, v in data.items()}, lcfg,
                 draws=draws)["total_loss"].backward()
    keys = compared_keys(model, data["rgb"].shape[0])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    return dict(pred=rel(p32, p64), dpred=rel(g32, g64),
                losses_alone=rel(pred.grad.double(), g64),
                **{name: norm_rel(
                    _backward(model, data, z, g64, torch.float32, train),
                    _backward(model, data, z, g64, torch.float64, train),
                    keys) for name, train in (
                        ("backward_alone", True),
                        ("backward_alone_bn_eval", False))})


def run(arch, hw, batch, d_latent, device):
    args = inputs(arch, hw, batch, d_latent)
    return dict(arch=arch, hw=hw, d_latent=d_latent, device=str(device),
                **compare(*args, device), cpu_split=split(*args))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--setting", action="append",
                    help="arch:hw:batch:d_latent (repeatable)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for s in args.setting or ["resnet18:64:2:8"]:
        arch, hw, batch, d_latent = s.split(":")
        print(json.dumps(run(arch, int(hw), int(batch), int(d_latent),
                             args.device)), flush=True)


if __name__ == "__main__":
    main()
