"""The training system: state, optimizer, train step and grid cadence
(port of google_nerf_tpu/train/system.py).

  * Adam(lr, eps=1e-15) with a per-epoch cosine from lr to lr/30; AdamW
    with decay on the encoder table only when weight_decay > 0; the pose
    refinement dR/dT in its own group at lr 1e-6 (optimize_ext);
  * a density-grid update every 16 steps, warmup (all cells) for the
    first 256;
  * per-step metrics: loss, psnr, s_per_ray, mask_frac, lr.

The state is a dict: params (leaf tensors), opt (the torch optimizer),
density_grid, occ, occ_u8 (the block2 tables) and step.  The step count
and the learning rate live on the host.  Shapes inside a step are static
(batch, budget and candidate counts fixed), and a step reads nothing
back to the host.  Every random draw comes from a torch.Generator or
from `draws`, a dict the caller passes (img_idxs, pix_idxs, bg, noise;
the grid update's per-cascade draws), so tests can hand in the draws
JAX made from its key.

The marchers: block2 (bench.py's recipe; one cascade only, so a
multi-cascade model takes seg, as JAX's does), seg (opt.py's default,
with super-segments when sup > 1) and the dense lattice, which also
takes every scene with an exponential step (exp_step_factor > 0:
colmap and nerfpp).  Any number of cascades (scale > 0.5), and the
grid's erosion (colmap), run.  The one-phase block marcher is ROADMAP
item 15.  With depth priors (lambda_depth > 0) the step's metrics
carry the depth term as depth_loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from google_nerf_tpu_torch.core.rays import axisangle_to_R, get_rays
from google_nerf_tpu_torch.models.ngp import NGPConfig, init_ngp, ngp_density
from google_nerf_tpu_torch.models.rendering import MAX_SAMPLES, render_train
from google_nerf_tpu_torch.ops.grid import (mark_invisible_cells,
                                            pack_occupancy_u8,
                                            update_density_grid)
from google_nerf_tpu_torch.ops.march_block import pack_occupancy_block2
from google_nerf_tpu_torch.ops.march_seg import required_dilation_radius
from google_nerf_tpu_torch.train.losses import NeRFLoss

SQRT3 = 3.0 ** 0.5
_TABLE_KEYS = ("packed_table", "pair_table", "hash_table")
_POSE_KEYS = ("dR", "dT")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: NGPConfig = NGPConfig()
    lr: float = 1e-2
    num_epochs: int = 30
    steps_per_epoch: int = 1000
    batch_size: int = 8192
    k_samples: int = 256          # padded samples per ray
    max_samples: int = MAX_SAMPLES
    exp_step_factor: float = 0.0
    optimize_ext: bool = False
    lambda_opacity: float = 1e-3
    lambda_depth: float = 0.0
    grid_update_interval: int = 16
    grid_sample_div: int = 4      # M = G^3 / div uniform (+ M occupied) cells
    warmup_steps: int = 256
    erode: bool = False
    T_threshold: float = 1e-4
    samples_budget: int = 0       # field evaluations per step (0 = R*K)
    random_bg: bool = False       # train against random backgrounds
    exclude_incomplete: str = "backfill"   # none | hard | floor | backfill
    incomplete_floor: float = 0.5  # "floor": keep >= this share supervised
    random_bg_per_ray: bool = True
    weight_decay: float = 0.0     # decoupled decay on the encoder table
    march: str = "seg"            # "seg" | "block2" | "dense"
    seg: int = 8                  # candidates per segment
    n_keep: int = 32              # live segments kept per ray
    sup: int = 4                  # segments per super-segment (0: none)
    n_keep_sup: int = 24          # live super-segments kept
    block_group: int = 0          # march="block" (ROADMAP item 15)
    n_keep_groups: int = 0        # block2: live groups kept (0: the reach)

    @property
    def density_threshold(self) -> float:
        return 0.01 * self.max_samples / SQRT3

    @property
    def total_steps(self) -> int:
        return self.num_epochs * self.steps_per_epoch


def _require_ported(cfg: TrainConfig):
    if cfg.march == "block":
        raise NotImplementedError(
            "march='block': the one-phase block marcher is ROADMAP item 15")


def _block2(cfg: TrainConfig) -> bool:
    """block2 runs on single-cascade models; others march seg."""
    return cfg.march == "block2" and cfg.model.cascades == 1


def pack_marching_grid(occ, cfg: TrainConfig):
    """The marcher's packed tables from the boolean grid: block2's dict,
    or the segment marcher's dilated word grid (super-dilated too when
    sup > 1)."""
    m = cfg.model
    if _block2(cfg):
        return pack_occupancy_block2(occ, max_samples=cfg.max_samples,
                                     scale=m.scale)
    return pack_occupancy_u8(
        occ, required_dilation_radius(cfg.seg, m.grid_size, cfg.max_samples,
                                      m.scale),
        super_radius=(required_dilation_radius(
            cfg.seg * cfg.sup, m.grid_size, cfg.max_samples, m.scale)
            if cfg.sup > 1 else 0))


def cosine_lr(cfg: TrainConfig):
    """Per-epoch cosine from lr to lr/30 (CosineAnnealingLR semantics):
    step -> lr, on the host."""
    eta_min = cfg.lr / 30

    def schedule(step: int) -> float:
        epoch = min(step // cfg.steps_per_epoch, cfg.num_epochs)
        return eta_min + 0.5 * (cfg.lr - eta_min) * (
            1 + math.cos(math.pi * epoch / cfg.num_epochs))

    return schedule


def param_leaves(params) -> Dict[str, torch.Tensor]:
    """{name: tensor} over params' leaves, names like sigma_mlp.0, in the
    order of sorted keys and list items (JAX's leaf order)."""
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, (list, tuple)):
            out.update({f"{k}.{i}": w for i, w in enumerate(v)})
        else:
            out[k] = v
    return out


def make_optimizer(cfg: TrainConfig, params):
    """One torch optimizer; its groups tagged "net" take the cosine lr
    (set_lr), the "pose" group keeps lr 1e-6."""
    net = [(k, p) for k, p in param_leaves(params).items()
           if k not in _POSE_KEYS]
    kw = dict(lr=cosine_lr(cfg)(0), eps=1e-15, weight_decay=0.0)
    if cfg.weight_decay > 0:
        groups = [dict(params=[p for k, p in net if k in _TABLE_KEYS],
                       weight_decay=cfg.weight_decay, tag="net"),
                  dict(params=[p for k, p in net if k not in _TABLE_KEYS],
                       tag="net")]
        cls = torch.optim.AdamW
    else:
        groups = [dict(params=[p for _, p in net], tag="net")]
        cls = torch.optim.Adam
    if cfg.optimize_ext:
        groups.append(dict(params=[params["dR"], params["dT"]], lr=1e-6,
                           tag="pose"))
    return cls(groups, **kw)


def set_lr(opt, cfg: TrainConfig, step: int):
    lr = cosine_lr(cfg)(step)
    for g in opt.param_groups:
        if g["tag"] == "net":
            g["lr"] = lr
    return lr


def init_train_state(cfg: TrainConfig, K, poses, img_wh, *, generator=None,
                     params=None, device="cuda") -> Dict[str, Any]:
    """K: (3, 3) intrinsics; poses: (N, 3, 4) c2w; img_wh: (w, h).
    params: init_ngp's from `generator` (a CPU Generator, seed 0 if None)
    unless given."""
    _require_ported(cfg)
    m = cfg.model
    if params is None:
        params = init_ngp(generator or torch.Generator().manual_seed(0), m,
                          device)
    if cfg.optimize_ext and "dR" not in params:
        n = len(poses)
        params["dR"] = torch.zeros((n, 3), device=device)
        params["dT"] = torch.zeros((n, 3), device=device)
    for p in param_leaves(params).values():
        p.requires_grad_(True)
    density_grid = mark_invisible_cells(
        K, poses, img_w=int(img_wh[0]), img_h=int(img_wh[1]),
        grid_size=m.grid_size, cascades=m.cascades, scale=m.scale,
        device=device)
    occ = torch.zeros((m.cascades,) + (m.grid_size,) * 3, dtype=torch.bool,
                      device=device)
    if _block2(cfg):
        gs4, gq = m.grid_size // 4, m.grid_size // 8
        occ_u8 = dict(
            blocks4=torch.zeros((gs4 ** 3, 16), dtype=torch.int32,
                                device=device),
            super=torch.zeros((gq ** 3,), dtype=torch.int32, device=device))
    else:
        occ_u8 = torch.zeros(occ.shape, dtype=torch.int32, device=device)
    return dict(params=params, opt=make_optimizer(cfg, params),
                density_grid=density_grid, occ=occ, occ_u8=occ_u8, step=0)


def refined_poses(params, poses, img_idxs):
    """Apply the dR/dT extrinsics refinement (fp32 elementwise products)."""
    p = poses[img_idxs]
    if "dR" not in params:
        return p
    dR = axisangle_to_R(params["dR"][img_idxs])
    R = (dR[:, :, :, None] * p[:, None, :, :3]).sum(2)
    t = p[..., 3] + params["dT"][img_idxs]
    return torch.cat([R, t[..., None]], -1)


def sample_batch(scene: Dict[str, Any], batch_size: int, *, generator=None,
                 img_idxs=None, pix_idxs=None):
    """A random (image, pixel) batch on the scene's device; img_idxs and
    pix_idxs are drawn from `generator` unless given."""
    rays = scene["images"]
    n_img, n_pix = rays.shape[0], rays.shape[1]
    dev = rays.device
    if img_idxs is None:
        img_idxs = torch.randint(0, n_img, (batch_size,),
                                 generator=generator, device=dev)
    if pix_idxs is None:
        pix_idxs = torch.randint(0, n_pix, (batch_size,),
                                 generator=generator, device=dev)
    img_idxs, pix_idxs = img_idxs.long(), pix_idxs.long()
    rgb = rays[img_idxs, pix_idxs]
    if rgb.dtype == torch.uint8:
        rgb = rgb.float() / 255.0
    batch = dict(rgb=rgb, img_idxs=img_idxs, pix_idxs=pix_idxs)
    if "alphas" in scene:
        batch["alpha"] = scene["alphas"][img_idxs, pix_idxs]
    if scene.get("depths") is not None:
        batch["depth"] = scene["depths"][img_idxs, pix_idxs]
    return batch


def loss_and_results(params, occ, scene, batch, cfg: TrainConfig, *,
                     step: Optional[int] = None, bg=None, noise=None,
                     generator=None):
    """The differentiable part of a train step.  occ: dict with "occ"
    and "occ_u8"; `step` gates the backfill (on from warmup_steps).
    bg (R, 3) or (3,) and noise (R,) are drawn from `generator` unless
    given."""
    _require_ported(cfg)
    step_now = cfg.warmup_steps if step is None else step
    poses = refined_poses(params, scene["poses"], batch["img_idxs"])
    dirs = scene["directions"][batch["pix_idxs"]]
    rays_o, rays_d = get_rays(dirs, poses)
    R, dev = rays_o.shape[0], rays_o.device
    bg_color = None
    if cfg.random_bg and "alpha" in batch:
        if bg is None:
            bg = torch.rand((R, 3) if cfg.random_bg_per_ray else (3,),
                            generator=generator, device=dev)
        bg_color = bg
        # re-composite the white-background ground truth onto bg
        batch = dict(batch)
        batch["rgb"] = batch["rgb"] - (1.0 - batch["alpha"])[:, None] \
            * (1.0 - bg_color)
    if noise is None:
        noise = torch.rand((R,), generator=generator, device=dev)
    results = render_train(
        params, cfg.model, occ["occ"], rays_o, rays_d, noise=noise,
        exp_step_factor=cfg.exp_step_factor, T_threshold=cfg.T_threshold,
        k_samples=cfg.k_samples, max_samples=cfg.max_samples,
        samples_budget=cfg.samples_budget,
        # the dense marcher reads the boolean grid; "dense" and the
        # exponential step take the render's fallback branch, as JAX's
        # march choice does
        occ_u8=(occ["occ_u8"] if cfg.march in ("seg", "block2")
                and cfg.exp_step_factor == 0.0 else None),
        march="block2" if _block2(cfg) else "seg", seg=cfg.seg, n_keep=cfg.n_keep, sup=cfg.sup,
        n_keep_sup=cfg.n_keep_sup, n_keep_groups=cfg.n_keep_groups,
        bg_color=bg_color,
        exclude_incomplete=cfg.exclude_incomplete,
        incomplete_floor=cfg.incomplete_floor, backfill_rgb=batch["rgb"],
        backfill_enable=step_now >= cfg.warmup_steps)
    total, terms = NeRFLoss(cfg.lambda_opacity, cfg.lambda_depth).total(
        results, batch)
    results["rgb_target"] = batch["rgb"]
    if "depth" in terms:
        results["depth_loss"] = terms["depth"].detach()
    return total, results


def loss_and_grads(state, scene, batch, cfg: TrainConfig, *, draws=None,
                   generator=None):
    """Loss, results and gradients ({leaf name: grad}) of one step, the
    state left as it was (its params' .grad cleared)."""
    draws = draws or {}
    params = state["params"]
    leaves = param_leaves(params)
    for p in leaves.values():
        p.grad = None
    loss, results = loss_and_results(
        params, state, scene, batch, cfg, step=state["step"],
        bg=draws.get("bg"), noise=draws.get("noise"), generator=generator)
    loss.backward()
    grads = {k: p.grad for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    return loss.detach(), results, grads


@torch.no_grad()
def _metrics(loss, results, batch_size: int, lr: float):
    rm = results["ray_mask"]
    rmw = rm[:, None].expand(results["rgb"].shape)
    err = (results["rgb"].detach() - results["rgb_target"]) ** 2
    mse = torch.where(rmw, err, 0.0).sum() / torch.clamp_min(rmw.sum(), 1)
    out = dict(loss=loss.detach(),
               psnr=-10.0 * torch.log10(torch.clamp_min(mse, 1e-10)),
               s_per_ray=results["total_samples"] / batch_size,
               mask_frac=rm.float().mean(), lr=lr)
    if "depth_loss" in results:
        out["depth_loss"] = results["depth_loss"]
    return out


def train_step(state, scene, batch, cfg: TrainConfig, *, draws=None,
               generator=None):
    """One optimization step on an explicit batch; updates state in
    place and returns (state, metrics).  draws: optional bg and noise."""
    draws = draws or {}
    opt = state["opt"]
    opt.zero_grad(set_to_none=True)
    loss, results = loss_and_results(
        state["params"], state, scene, batch, cfg, step=state["step"],
        bg=draws.get("bg"), noise=draws.get("noise"), generator=generator)
    loss.backward()
    lr = set_lr(opt, cfg, state["step"])
    opt.step()
    metrics = _metrics(loss, results, batch["rgb"].shape[0], lr)
    state["step"] += 1
    return state, metrics


def fused_train_step(state, scene, cfg: TrainConfig, *, draws=None,
                     generator=None):
    """Sample a batch on the device, then train_step.  draws: optional
    img_idxs, pix_idxs, bg and noise."""
    draws = draws or {}
    batch = sample_batch(scene, cfg.batch_size, generator=generator,
                         img_idxs=draws.get("img_idxs"),
                         pix_idxs=draws.get("pix_idxs"))
    return train_step(state, scene, batch, cfg, draws=draws,
                      generator=generator)


@torch.no_grad()
def grid_update_step(state, cfg: TrainConfig, *, warmup: bool, draws=None,
                     generator=None):
    """Density-grid maintenance: update the grid, its occupancy and the
    marcher's packed tables in place.  draws: ops.grid.grid_draws'
    list."""
    _require_ported(cfg)
    m = cfg.model
    params = state["params"]
    new_grid, occ = update_density_grid(
        state["density_grid"], lambda x: ngp_density(params, m, x),
        scale=m.scale, density_threshold=cfg.density_threshold,
        warmup=warmup, erode=cfg.erode, sample_div=cfg.grid_sample_div,
        generator=generator, draws=draws)
    state["density_grid"] = new_grid
    state["occ"] = occ
    state["occ_u8"] = pack_marching_grid(occ, cfg)
    return state


def run_training(state, scene, cfg: TrainConfig, *, steps: int,
                 generator=None, log_every: int = 0, log_fn=print):
    """Host driver: the grid cadence and fused steps.  Returns the state
    and the last step's metrics (device tensors)."""
    metrics = None
    for _ in range(steps):
        step = state["step"]
        if step % cfg.grid_update_interval == 0:
            grid_update_step(state, cfg, warmup=step < cfg.warmup_steps,
                             generator=generator)
        state, metrics = fused_train_step(state, scene, cfg,
                                          generator=generator)
        if log_every and (step + 1) % log_every == 0:
            log_fn(f"step {step + 1}: " + " ".join(
                f"{k}={float(v):.4g}" for k, v in metrics.items()))
    return state, metrics
