"""The cIMLE depth-training system (port of
google_nerf_tpu/depth/trainer.py; the reference's
`Train/tools/train.py:127-434`, do_train):

  * every `recache_epochs` epochs (and at the first), draw `num_latent`
    latents z ~ N(0, 1)^d per image in minibatches of
    `latent_minibatch`, and keep each image's z of the least total_raw
    (`train.py:174-251`); the hypotheses are folded into the batch
    (`train.py:203-208`) and BatchNorm runs on its running statistics;
  * the epoch loop trains on (batch, cached z) with train-mode
    BatchNorm, the losses, their backward pass and DepthSGD (warmup
    multistep schedule, clip 10), a checkpoint every `ckpt_epochs`.

Every forward and backward runs in float32 with TF32 off
(utils.precision.exact_f32), as JAX's float32 reference.  Random draws
come from torch.Generators seeded by (seed, stream, index), so a resumed
run draws what the uninterrupted run would have: the init from the
seed, epoch e's latents from (seed, 1, e), step s's loss draws from
(seed, 2, s).  The z-cache and the train step take `draws` (the loss
draws) and calibrate_adain a `latents(b, zi)` hook in place of the
generators' (a test passes JAX's).

Batches from depth.data are numpy in JAX's layout; `batch_to_device`
makes rgb NCHW tensors on the training device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from google_nerf_tpu_torch.depth.config import DepthCfg
from google_nerf_tpu_torch.depth.losses import LossConfig, depth_losses
from google_nerf_tpu_torch.depth.model import (DepthModelConfig, DepthNet,
                                               get_adain_init_act,
                                               init_depth_model,
                                               set_mean_var_shifts)
from google_nerf_tpu_torch.depth.optim import (DepthSGD,
                                               make_depth_optimizer,
                                               warmup_multistep_lr)
from google_nerf_tpu_torch.utils.precision import exact_f32

STREAM_LATENTS, STREAM_STEPS = 1, 2


def model_config(cfg: DepthCfg, with_auxi: bool = False
                 ) -> DepthModelConfig:
    site = "decoder" if cfg.model.cimle_version in ("v3", "v4", "v5",
                                                    "v6") else "encoder"
    return DepthModelConfig(backbone=cfg.model.encoder,
                            d_latent=cfg.model.d_latent, cimle_site=site,
                            with_auxi=with_auxi)


def loss_config(cfg: DepthCfg) -> LossConfig:
    return LossConfig(loss_mode=cfg.train.loss_mode,
                      loss_auxi_weight=cfg.train.loss_auxi_weight,
                      focal_x=cfg.dataset.focal_x,
                      focal_y=cfg.dataset.focal_y)


def seeded_generator(seed: int, stream: int = 0, index: int = 0
                     ) -> torch.Generator:
    """A CPU generator for draw stream `stream` at `index` of a run
    seeded by `seed`."""
    return torch.Generator().manual_seed(
        ((seed * 1_000_003 + stream) * 1_000_033 + index) % (2 ** 63))


@dataclasses.dataclass
class DepthTrainState:
    model: DepthNet
    optimizer: DepthSGD
    step: int = 0


def make_optimizer(model: DepthNet, cfg: DepthCfg) -> DepthSGD:
    t = cfg.train
    sched = warmup_multistep_lr(1.0, t.lr_milestones,
                                warmup_iters=t.warmup_iters)
    return make_depth_optimizer(model, t.base_lr,
                                scale_decoder_lr=t.scale_decoder_lr,
                                mlp_lr=t.mlp_lr, schedule=sched,
                                fixed_backbone=cfg.model.freeze_backbone)


def init_trainer(seed: int, cfg: DepthCfg, device="cuda"):
    """(DepthTrainState, DepthModelConfig): the model drawn from `seed`
    as flax initialises it, on `device`, and its optimizer."""
    mcfg = model_config(cfg)
    model = init_depth_model(seeded_generator(seed), mcfg, device)
    return DepthTrainState(model, make_optimizer(model, cfg)), mcfg


def batch_to_device(batch: Dict[str, Any], device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch of depth.data items -> tensors on `device`, rgb
    (B, 3, H, W)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if k == "rgb":
            t = t.permute(0, 3, 1, 2)
        out[k] = t.contiguous().to(device)
    return out


def forward_losses(model: DepthNet, data, z, lcfg: LossConfig,
                   generator=None, draws=None) -> Dict[str, torch.Tensor]:
    """The forward and depth_losses on its logit (B, H, W)."""
    out = model(data["rgb"], z if model.cfg.d_latent else None)
    auxi = None
    if model.cfg.with_auxi:
        out, auxi = out[0], out[1][:, 0]
    return depth_losses(out[:, 0], data, lcfg, auxi=auxi,
                        generator=generator, draws=draws)


@torch.no_grad()
def zcache_losses(model: DepthNet, lcfg: LossConfig, data, z,
                  generator=None, draws=None) -> torch.Tensor:
    """total_raw (B, M) of each image under each of its M latents z
    (B, M, d): the hypotheses folded into the batch, BatchNorm on its
    running statistics."""
    b, m, d = z.shape
    rep = {k: v.repeat_interleave(m, dim=0) for k, v in data.items()}
    model.eval()
    with exact_f32():
        losses = forward_losses(model, rep, z.reshape(b * m, d), lcfg,
                                generator, draws)
    return losses["total_raw"].reshape(b, m)


def loss_and_grads(model: DepthNet, data, z, lcfg: LossConfig,
                   generator=None, draws=None):
    """The train-mode forward (BatchNorm on the batch, its running
    statistics updated), the losses and the backward pass, in float32:
    (the loss dict, {parameter name: its gradient})."""
    model.train()
    for p in model.parameters():
        p.grad = None
    try:
        with exact_f32():
            losses = forward_losses(model, data, z, lcfg, generator, draws)
            losses["total_loss"].backward()
    finally:
        model.eval()
    return losses, {k: p.grad for k, p in model.named_parameters()}


def bn_fed_biases(model: nn.Module) -> List[str]:
    """The biases of convolutions whose output goes straight into a
    BatchNorm (FTB's conv_branch.1, AO's adapt_conv.0): in train mode
    the BatchNorm takes out each channel's batch mean, so their gradient
    is zero in exact arithmetic and their float32 gradient is rounding
    noise, which no comparison can hold to a relative bound."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Sequential):
            kids = list(mod.named_children())
            for (n, a), (_, b) in zip(kids, kids[1:]):
                if (isinstance(a, nn.Conv2d) and a.bias is not None
                        and isinstance(b, nn.BatchNorm2d)):
                    out.append(f"{name}.{n}.bias")
    return out


def train_step(state: DepthTrainState, data, z, lcfg: LossConfig,
               generator=None, draws=None) -> Dict[str, torch.Tensor]:
    """One step: loss_and_grads, then the optimizer.  Returns the scalar
    losses (0-d tensors)."""
    losses, _ = loss_and_grads(state.model, data, z, lcfg, generator,
                               draws)
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in losses.items() if v.ndim == 0}


def recache_z(seed: int, epoch: int, state: DepthTrainState, sampler,
              cfg: DepthCfg, lcfg: LossConfig, log=print) -> np.ndarray:
    """The argmin-z selection over every image of epoch 0's order
    (`train.py:174-251`): (n_images, d_latent)."""
    t = cfg.train
    d_latent = cfg.model.d_latent
    dev = next(state.model.parameters()).device
    num_sets = t.num_latent // t.latent_minibatch
    gen = seeded_generator(seed, STREAM_LATENTS, epoch)
    idxs = sampler.epoch_indices(0)
    selected = np.zeros((len(idxs), d_latent), np.float32)
    for i, (ds_i, it_i) in enumerate(idxs):
        item = sampler.datasets[ds_i].get_val(it_i)
        data = batch_to_device({k: np.asarray(v)[None]
                                for k, v in item.items()}, dev)
        best_loss, best_z = np.inf, None
        for k in range(num_sets):
            z = torch.randn((1, t.latent_minibatch, d_latent),
                            generator=gen)
            raw = zcache_losses(state.model, lcfg, data, z.to(dev),
                                generator=gen)
            raw = raw[0].cpu().numpy()
            j = int(np.argmin(raw))
            if raw[j] < best_loss:
                best_loss, best_z = float(raw[j]), z[0, j].cpu().numpy()
        selected[i] = best_z
        if i % 100 == 0:
            log(f"z-cache {i}/{len(idxs)}")
    return selected


def resume_state(state: DepthTrainState, resume: Dict[str, Any]) -> int:
    """Load a resumable checkpoint's tree (model, opt, step, epoch, as
    depth_train_torch.py writes it) into state; returns its epoch."""
    state.model.load_state_dict(resume["model"])
    state.optimizer.load_state_dict(resume["opt"])
    state.step = int(resume["step"])
    return int(resume["epoch"])


def _wall(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time()


def train_depth(seed: int, cfg: DepthCfg, sampler,
                epochs: Optional[int] = None, log=print,
                ckpt_fn: Optional[Callable] = None,
                resume: Optional[Dict[str, Any]] = None, device="cuda",
                history: Optional[list] = None) -> DepthTrainState:
    """The whole cIMLE loop (`do_train`).  resume: the tree of a
    resumable checkpoint (resume_state).  history: a list that gets one
    dict per recache (epoch, seconds, images) and per step (epoch, step,
    seconds, the scalar losses as floats), timed to the device's end of
    the work."""
    state, _ = init_trainer(seed, cfg, device)
    start_epoch = resume_state(state, resume) if resume is not None else 0
    lcfg = loss_config(cfg)
    t = cfg.train
    epochs = epochs if epochs is not None else t.epochs
    selected_z = None
    for epoch in range(start_epoch, epochs):
        dev = next(state.model.parameters()).device
        if selected_z is None or epoch % t.recache_epochs == 0:
            log(f"epoch {epoch}: re-caching z")
            t0 = _wall(dev)
            selected_z = recache_z(seed, epoch, state, sampler, cfg, lcfg,
                                   log=log)
            if history is not None:
                history.append(dict(kind="recache", epoch=epoch,
                                    seconds=_wall(dev) - t0,
                                    images=len(selected_z)))
        idx_of = {pair: i for i, pair in enumerate(sampler.epoch_indices(0))}
        order = sampler.epoch_indices(epoch)
        t0 = time.time()
        for bi, batch in enumerate(sampler.batches(epoch, t.batch_size)):
            pairs = order[bi * t.batch_size:(bi + 1) * t.batch_size]
            z = torch.from_numpy(np.stack([selected_z[idx_of[p]]
                                           for p in pairs])).to(dev)
            t1 = _wall(dev) if history is not None else 0.0
            data = batch_to_device(batch, dev)
            scalars = train_step(
                state, data, z, lcfg,
                generator=seeded_generator(seed, STREAM_STEPS, state.step))
            if history is not None:
                history.append(dict(
                    kind="step", epoch=epoch, step=state.step,
                    seconds=_wall(dev) - t1,
                    **{k: float(v) for k, v in scalars.items()}))
            if state.step % t.log_interval == 0:
                msg = " ".join(f"{k}={float(v):.4g}"
                               for k, v in scalars.items())
                log(f"e{epoch} s{state.step} ({time.time() - t0:.1f}s) "
                    f"{msg}")
        if ckpt_fn is not None and (epoch + 1) % t.ckpt_epochs == 0:
            ckpt_fn(state, epoch)
    return state


@torch.no_grad()
def calibrate_adain(seed: int, state: DepthTrainState, sampler,
                    cfg: DepthCfg, n_batches: int = 4, n_z: int = 4,
                    latents: Optional[Callable] = None) -> DepthTrainState:
    """The AdaIN calibration (trainer v3/v4, `get_adain_init_act` and
    `set_mean_var_shifts`, `Resnext_torch.py:464-476`): the per-channel
    mean and standard deviation of each encoder AdaIN point's
    activations over the first n_batches images of epoch 0 and n_z
    latents each (latents(b, zi) -> (1, d), or drawn from the seed),
    written as its shifts, so the modulated activations start
    standardised."""
    model = state.model
    if model.cfg.cimle_site != "encoder" or not model.cfg.d_latent:
        raise ValueError("calibrate_adain needs the encoder-site AdaIN")
    model.eval()
    dev = next(model.parameters()).device
    gen = seeded_generator(seed)
    sums = sqs = None
    count = 0
    idxs = sampler.epoch_indices(0)
    for b in range(min(n_batches, len(idxs))):
        ds_i, it_i = idxs[b]
        item = sampler.datasets[ds_i].get_val(it_i)
        rgb = batch_to_device({"rgb": item["rgb"][None]}, dev)["rgb"]
        for zi in range(n_z):
            z = (torch.tensor(np.asarray(latents(b, zi), np.float32))
                 if latents is not None else
                 torch.randn((1, cfg.model.d_latent), generator=gen))
            acts = get_adain_init_act(model, rgb, z.to(dev))
            means = [a.mean((0, 2, 3)) for a in acts]
            squares = [(a * a).mean((0, 2, 3)) for a in acts]
            if sums is None:
                sums, sqs = means, squares
            else:
                sums = [s + m for s, m in zip(sums, means)]
                sqs = [s + m for s, m in zip(sqs, squares)]
            count += 1
    means = [s / count for s in sums]
    stds = [torch.sqrt(torch.clamp_min(q / count - m * m, 0.0))
            for m, q in zip(means, sqs)]
    set_mean_var_shifts(model, means, stds)
    return state
