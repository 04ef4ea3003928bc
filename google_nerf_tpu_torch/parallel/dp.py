"""Data-parallel training and serving on torch.distributed (port of
google_nerf_tpu/parallel/dp.py).

JAX runs one program over a device mesh; the port runs one process a
device in a process group (init_distributed, or launch.run_world), as
the reference's NCCL DDP does (`ngp_pl/train.py:262`).  The mesh's
layout maps onto ranks so:

  * params, Adam moments, density grid, occupancy, step: held by every
    rank, made equal by one broadcast from rank 0 (replicate) and kept
    equal by equal updates;
  * the ray batch: each rank samples its own batch_size // world rays;
  * gradients and the loss, mse and s_per_ray: averaged over the ranks
    in one flattened all-reduce (SUM, then a division by the world);
  * the grid update: every rank takes the same draws and evaluates its
    share of the sampled cells; the maxima are merged with MAX
    (make_dp_grid_update);
  * serving: each rank renders its contiguous shard of the rays with the
    port's serial renderer, and the shards are gathered onto every rank
    (comm.all_gather_cat).

Backends: NCCL on cards (a rank a card, cuda:LOCAL_RANK), gloo on the
CPU or when a caller asks for it, as for two ranks sharing one card.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from google_nerf_tpu_torch.parallel import comm
from google_nerf_tpu_torch.train.system import (TrainConfig, apply_grads,
                                                grid_update_step,
                                                loss_and_grads, masked_mse,
                                                param_leaves, sample_batch)


def init_distributed(backend=None, device_type="cuda"):
    """Join torchrun's world: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
    and MASTER_PORT from the environment (the reference's
    init_process_group, `LeReS Train/tools/train.py:462-465`).
    device_type: "cuda" (the default: the rank's card is
    cuda:LOCAL_RANK, backend NCCL; raises without a card) or "cpu"
    (backend gloo); `backend` overrides.  Without WORLD_SIZE in the
    environment there is no group to join: a world of one, as JAX's
    single-host run.  A failed join raises.  Returns (rank, device)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA card; pass "
                           "device_type='cpu' to join on the CPU (gloo)")
    if "WORLD_SIZE" not in os.environ and not comm.initialized():
        return 0, torch.device(device_type)
    if device_type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not comm.initialized():
        dist.init_process_group(
            backend or ("nccl" if device_type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dev


def _opt_tensors(opt):
    """The optimizer state's tensors (Adam's moments and step counts), in
    the order of the optimizer's params."""
    out = []
    for g in opt.param_groups:
        for p in g["params"]:
            st = opt.state.get(p, {})
            out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    return out


@torch.no_grad()
def replicate(state, group=None, src: int = 0):
    """Every rank's state made rank src's, in place: params, Adam moments,
    density grid, occupancy, the marcher's tables and the step (JAX's
    replicated P() placement).  Every rank's optimizer must hold state
    for the same params.  Returns the state."""
    if comm.get_world_size(group) == 1:
        return state
    for p in param_leaves(state["params"]).values():
        comm.broadcast_(p.detach(), src, group)
    for t in _opt_tensors(state["opt"]):
        comm.broadcast_(t, src, group)
    for k in ("density_grid", "occ"):
        comm.broadcast_(state[k], src, group)
    words = state["occ_u8"]
    for t in (words.values() if isinstance(words, dict) else (words,)):
        comm.broadcast_(t, src, group)
    state["step"] = comm.all_gather_objects(state["step"], group)[src]
    return state


def make_dp_train_step(cfg: TrainConfig, group=None,
                       collectives: bool = True):
    """Returns step(state, scene, *, draws=None, generator=None) ->
    (state, metrics): one data-parallel training step on this rank.

    Each rank samples batch_size // world rays through the same cfg (so
    each rank keeps the full samples_budget, as each JAX replica does)
    from its own draws (`draws`, else `generator`: give every rank its
    own), runs loss_and_grads, averages the gradients and its loss, mse
    and s_per_ray over the ranks in one flattened all-reduce, and then
    applies the gradients (apply_grads).  metrics: loss, psnr (of the
    averaged mse), s_per_ray, lr (`dp.py:87-94`).  step.allreduce_bytes
    holds the bytes one step all-reduces.

    collectives=False is a TIMING PROBE ONLY: the all-reduce is skipped,
    so the replicas' params drift apart and the step is numerically
    wrong for training.  weak_scaling_report times the step with and
    without it to split compute from the gradient all-reduce."""
    n = comm.get_world_size(group)
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"the world size {n}")
    local_bs = cfg.batch_size // n

    def step(state, scene, *, draws=None, generator=None):
        draws = draws or {}
        batch = sample_batch(scene, local_bs, generator=generator,
                             img_idxs=draws.get("img_idxs"),
                             pix_idxs=draws.get("pix_idxs"))
        loss, results, grads = loss_and_grads(state, scene, batch, cfg,
                                              draws=draws,
                                              generator=generator)
        leaves = param_leaves(state["params"])
        names = [k for k in leaves if grads.get(k) is not None]
        stats = torch.stack([loss.float(), masked_mse(results).float(),
                             results["total_samples"].float() / local_bs])
        flat = torch.cat([grads[k].reshape(-1).float() for k in names]
                         + [stats])
        step.allreduce_bytes = flat.numel() * flat.element_size()
        if collectives and comm.initialized():
            # a group of one still takes the all-reduce: its backend's path
            dist.all_reduce(flat, group=group)
            flat = flat / n
        reduced, at = {}, 0
        for k in names:
            g = grads[k]
            reduced[k] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
        loss, mse, s_per_ray = flat[at:].unbind()
        lr = apply_grads(state, reduced, cfg)
        state["step"] += 1
        metrics = dict(loss=loss,
                       psnr=-10.0 * torch.log10(torch.clamp_min(mse, 1e-10)),
                       s_per_ray=s_per_ray, lr=lr)
        return state, metrics

    step.allreduce_bytes = 0
    return step


def make_dp_grid_update(cfg: TrainConfig, group=None):
    """Returns update(state, *, warmup, draws=None, generator=None): the
    sharded density-grid update (`dp.py:115-173`) in place.  Every rank
    must take the same draws (the same `draws`, or generators in the
    same state); each evaluates its share of the fixed-shape chunks and
    the maxima are merged with MAX, so the grid equals the serial update
    bit for bit.  The occupancy is then packed into the layout cfg.march
    selects (pack_marching_grid), as grid_update_step packs it."""
    def update(state, *, warmup: bool, draws=None, generator=None):
        return grid_update_step(state, cfg, warmup=warmup, draws=draws,
                                generator=generator, sharded=True,
                                group=group)

    return update


def _ray_shard(rays_o, rays_d, group):
    """This rank's contiguous shard of the rays, padded to a multiple of
    the world (pad rays from the origin along (1, 1, 1), as JAX's), and
    R."""
    n, r = comm.get_world_size(group), comm.get_rank(group)
    R = rays_o.shape[0]
    pad = (-R) % n
    if pad:
        dev = rays_o.device
        rays_o = torch.cat([rays_o, torch.zeros((pad, 3), device=dev)])
        rays_d = torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
    per = (R + pad) // n
    return rays_o[r * per:(r + 1) * per], rays_d[r * per:(r + 1) * per], R


def _gather_rays(out, per: int, R: int, group):
    """The per-ray fields of a shard's output gathered onto every rank and
    cut to R rays; other entries are dropped."""
    return {k: comm.all_gather_cat(v, group)[:R] for k, v in out.items()
            if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == per}


@torch.no_grad()
def render_test_fast_dp(params, cfg, occ_u8, rays_o, rays_d, group=None,
                        **kw):
    """Data-parallel novel-view render (`dp.py:176-203`): the rays (padded
    to a multiple of the world) sharded over the ranks, each rank's shard
    through render_test_fast, the shards gathered onto every rank.  Rays
    are independent, so the frame is the serial renderer's."""
    from google_nerf_tpu_torch.models.render_test_fast import \
        render_test_fast
    o, d, R = _ray_shard(rays_o, rays_d, group)
    out = render_test_fast(params, cfg, occ_u8, o, d, **kw)
    return _gather_rays(out, o.shape[0], R, group)


@torch.no_grad()
def render_test_oneshot_dp(params, cfg, occ_u8, rays_o, rays_d, group=None,
                           **kw):
    """Data-parallel one-shot serving render (`dp.py:206-233`): each
    rank's shard through render_test_oneshot (main pass and drain), the
    per-ray fields gathered onto every rank; the drain's scalar counts
    differ from rank to rank and are dropped."""
    from google_nerf_tpu_torch.models.render_test_oneshot import \
        render_test_oneshot
    o, d, R = _ray_shard(rays_o, rays_d, group)
    out = render_test_oneshot(params, cfg, occ_u8, o, d, **kw)
    return _gather_rays(out, o.shape[0], R, group)


_TELEMETRY = ("trunc_tiles", "trunc_rays", "pairs_dropped", "pairs_total")


@torch.no_grad()
def render_brick_dp(baked, cfg, rays_o, rays_d, W, H, group=None, *,
                    bcfg=None, tile: int = 8, L: int = 256, Lk: int = 24,
                    max_samples: int = 512, T_threshold: float = 1e-2,
                    pairs_per_ray: float = 3.0, pass_fracs: tuple = (),
                    drain_frac: float = 0.25, macro_tiles: int = 8,
                    macro_L: int = 1024, chunk_tiles: int = 2048,
                    geometry=None, device="cuda"):
    """Data-parallel brick serving render (`dp.py:236-324`): the
    tile-ordered ray stream in the chunks render_brick renders it in
    (chunk_tiles tiles, at most the frame's), the chunks block-sharded
    over the ranks (the stream padded with rays that miss to a whole
    number of chunks a rank); each rank renders its band of chunks as
    render_brick does, so every chunk, its pairs budget and its macro
    tiles are the serial frame's; the bands are gathered onto every rank,
    un-permuted, and the white background added.  The telemetry
    (trunc_tiles, trunc_rays, pairs_dropped, pairs_total) is summed over
    the ranks.  JAX shards the tiles evenly and renders a band in one
    call, whose pairs budget is the band's."""
    from google_nerf_tpu_torch.models.baked import BakedConfig
    from google_nerf_tpu_torch.models.render_brick import (frame_of_stream,
                                                           on_device,
                                                           pad_stream,
                                                           render_stream,
                                                           tile_stream)
    bcfg = BakedConfig() if bcfg is None else bcfg
    n, r = comm.get_world_size(group), comm.get_rank(group)
    baked, geometry = on_device(baked, geometry, bcfg, cfg, device)
    ro_t, rd_t, inv, Wp, Hp = tile_stream(rays_o, rays_d, W, H, tile,
                                          device)
    tpx = tile * tile
    n_tiles = (Wp * Hp) // tpx
    cpr = max(min(int(chunk_tiles), n_tiles), 1)
    band = -(-n_tiles // (n * cpr)) * cpr           # whole chunks a rank
    ro_t, rd_t = pad_stream(ro_t, rd_t, n * band - n_tiles, tpx)
    cat = render_stream(
        baked, geometry, cfg, ro_t[r * band * tpx:(r + 1) * band * tpx],
        rd_t[r * band * tpx:(r + 1) * band * tpx], bcfg=bcfg, tile=tile,
        L=L, Lk=Lk, max_samples=max_samples, T_threshold=T_threshold,
        chunk_tiles=cpr, pairs_per_ray=pairs_per_ray,
        pass_fracs=pass_fracs, drain_frac=drain_frac,
        macro_tiles=macro_tiles, macro_L=macro_L)
    tele = torch.stack([cat[k].to(torch.int64) for k in _TELEMETRY])
    if n > 1:
        dist.all_reduce(tele, group=group)
    full = {k: comm.all_gather_cat(cat[k], group)
            for k in ("rgb", "opacity", "depth")}
    return dict(frame_of_stream(full, inv, W, H, Wp, Hp, 1.0),
                **dict(zip(_TELEMETRY, tele.unbind())))


def shard_scene_for_host(scene, n_hosts: int, host_id: int):
    """Host-sharded image store (`dp.py:350-364`): host host_id keeps
    images host_id, host_id + n_hosts, ... and their poses (and depths
    and alphas where the scene has them), the DDP sampler's analog."""
    idx = np.arange(host_id, scene["images"].shape[0], n_hosts)
    out = dict(scene)
    for k in ("images", "poses", "depths", "alphas"):
        if scene.get(k) is not None:
            v = scene[k]
            out[k] = v[torch.as_tensor(idx, device=v.device)] \
                if torch.is_tensor(v) else v[idx]
    return out
