"""The rank side of the data-parallel tests, and the world launcher's own
tests.

The tests of parallel/ (test_torch_parallel.py, test_torch_dp_render.py,
test_torch_multiscene.py, test_torch_depth_parallel.py,
test_torch_cli_dp.py) each spawn one gloo world of two ranks on the CPU
(parallel/launch.run_world: one thread a rank, a free loopback port, a
join timeout) that runs every case of the file and hands its results back
as numpy arrays; the pytest process computes the serial port and JAX
sides.  Their rank functions live here, in a module that imports no JAX,
so that a spawned rank imports only torch and the port.

Here: a rank that raises or outlives the timeout fails its world at
once (no world can hang the suite), and the comm helpers at world 2.
"""
import os
import time

import numpy as np
import pytest
import torch

from google_nerf_tpu_torch.parallel import comm
from google_nerf_tpu_torch.parallel.launch import run_world


def t(a):
    return torch.as_tensor(np.asarray(a))


def tree_t(d):
    return {k: (tree_t(v) if isinstance(v, dict) else t(v))
            for k, v in d.items()}


def rank_args(per_rank):
    """This rank's entry of a per-rank list."""
    return per_rank[comm.get_rank()]


# --------------------------------------------------- test_torch_parallel


def parallel_cases(tree, scene, cfg, jdraws, positions, grid_case,
                   ngp_draws, b2, xs):
    """Every case of test_torch_parallel.py on this rank.

    tree/scene/cfg: a converted JAX train state, its scene and the port's
    config; jdraws: per rank, JAX's per-replica draws of one DP step;
    positions: per rank, the sample positions JAX's step evaluated its
    field on;
    grid_case: the analytic-density update's (grid, draws); ngp_draws:
    JAX's draws of one NGP grid update; b2: test_dp_block2_march_trains'
    config and scene; xs: per rank, the reduce_dict inputs."""
    from google_nerf_tpu_torch.convert import train_state_from_jax
    from google_nerf_tpu_torch.ops.grid import update_density_grid
    from google_nerf_tpu_torch.parallel import dp
    from google_nerf_tpu_torch.train import system as tsys
    rank = comm.get_rank()
    sc = tree_t(scene)
    out = {}

    # the first DP step on JAX's per-replica draws: the reduced gradients
    # (as apply_grads receives them), then two more steps on the ranks'
    # own generators
    draws = {k: t(v) for k, v in rank_args(jdraws).items()}
    st = train_state_from_jax(tree, cfg, "cpu")
    step = dp.make_dp_train_step(cfg)
    seen = {}
    apply = dp.apply_grads

    def capture(state, grads, c):
        seen.update({k: g.clone() for k, g in grads.items()})
        return apply(state, grads, c)

    dp.apply_grads = capture
    try:
        st, m = step(st, sc, draws=draws)
    finally:
        dp.apply_grads = apply
    out["reduced"] = seen
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["allreduce_bytes"] = step.allreduce_bytes
    for i in range(2):
        st, m = step(st, sc, generator=torch.Generator().manual_seed(
            10 + rank + 2 * i))
    out["after3"] = {k: v.detach() for k, v in
                     tsys.param_leaves(st["params"]).items()}
    out["step_after3"] = st["step"]
    out["loss_after3"] = float(m["loss"])

    # the same first step with the field evaluated on JAX's positions
    from google_nerf_tpu_torch.models import ngp as tngp
    density, seen = tngp.ngp_density, {}
    xj = t(rank_args(positions))

    def on_jax_positions(params, c, x, return_feat=False):
        seen["x_err"] = float((x - xj).abs().max())
        return density(params, c, xj, return_feat)

    dp.apply_grads = capture
    tngp.ngp_density = on_jax_positions
    try:
        dp.make_dp_train_step(cfg)(train_state_from_jax(tree, cfg, "cpu"),
                                   sc, draws=draws)
    finally:
        dp.apply_grads = apply
        tngp.ngp_density = density
    out["reduced_on_jax_positions"] = {k: v for k, v in seen.items()
                                       if k != "x_err"}
    out["x_err"] = seen["x_err"]

    # collectives=False: the replicas move apart
    st = train_state_from_jax(tree, cfg, "cpu")
    probe = dp.make_dp_train_step(cfg, collectives=False)
    st, _ = probe(st, sc, draws=draws)
    out["nocoll_table"] = st["params"]["packed_table"].detach()

    # the sharded grid update, analytic density, on the serial draws
    grid0, gdraws = grid_case
    out["analytic"] = update_density_grid(
        t(grid0), lambda x: torch.exp(-10 * (x ** 2).sum(-1)), scale=0.5,
        density_threshold=0.5, warmup=False, sharded=True,
        draws=[{k: t(v) for k, v in d.items()} for d in gdraws])

    # the sharded NGP update with block2 packing on JAX's grid draws
    st = train_state_from_jax(tree, cfg, "cpu")
    dp.make_dp_grid_update(cfg)(st, warmup=False, draws=[
        {k: t(v) for k, v in d.items()} for d in ngp_draws])
    out["ngp_grid"] = {k: st[k] for k in ("density_grid", "occ", "occ_u8")}

    # test_dp_block2_march_trains: a fresh state, the DP warmup update,
    # three DP steps on block2's tables
    st = tsys.init_train_state(b2["cfg"], b2["K"], b2["poses"],
                               b2["img_wh"], device="cpu")
    dp.make_dp_grid_update(b2["cfg"])(        # the same draws on each rank
        st, warmup=True, generator=torch.Generator().manual_seed(1))
    out["block2_is_dict"] = isinstance(st["occ_u8"], dict)
    step2 = dp.make_dp_train_step(b2["cfg"])
    for i in range(3):
        st, m = step2(st, tree_t(b2["scene"]),
                      generator=torch.Generator().manual_seed(
                          20 + rank + 2 * i))
    out["block2_metrics"] = {k: float(v) for k, v in m.items()}
    out["block2_table"] = st["params"]["packed_table"].detach()

    # a world that does not divide the batch is refused
    import dataclasses
    try:
        dp.make_dp_train_step(dataclasses.replace(cfg, batch_size=255))
        out["odd_batch"] = "accepted"
    except ValueError as e:
        out["odd_batch"] = str(e)

    # comm at world 2
    x = t(rank_args(xs))
    out["reduce_mean"] = float(comm.reduce_dict({"a": x.sum()})["a"])
    out["reduce_sum"] = float(comm.reduce_dict({"a": x.sum()},
                                               average=False)["a"])
    out["loss_dict"] = {k: float(v) for k, v in comm.reduce_loss_dict(
        {"a": x.sum(), "b": x.max()}).items()}
    out["gathered"] = comm.all_gather_objects({"rank": rank})
    out["gather_cat"] = comm.all_gather_cat(x[None] * (rank + 1))
    out["world"] = (comm.get_world_size(), comm.get_rank(),
                    comm.is_main_process())
    comm.synchronize()
    return out


# ---------------------------------------------------- test_torch_dp_render


def render_cases(cfg, cases, brick):
    """The three DP renderers on this rank: cases {name: (renderer
    "fast" or "oneshot", JAX's params, occ_u8, rays_o, rays_d,
    keywords)}; brick (its NGPConfig, the bake with its pool's bf16 bits
    as int16, bcfg, rays_o, rays_d, W, H, keywords)."""
    from google_nerf_tpu_torch.convert import params_from_jax
    from google_nerf_tpu_torch.parallel import dp
    fns = dict(fast=dp.render_test_fast_dp,
               oneshot=dp.render_test_oneshot_dp)
    out = {}
    for name, (kind, params, words, o, d, kw) in cases.items():
        words = tree_t(words) if isinstance(words, dict) else t(words)
        out[name] = fns[kind](params_from_jax(params, "cpu"), cfg, words,
                              t(o), t(d), **kw)
    bcfg_model, baked, bcfg, o, d, W, H, kw = brick
    baked = dict(baked, pool=t(baked["pool"]).view(torch.bfloat16),
                 block_map=t(baked["block_map"]),
                 rgb_mlp=[t(w) for w in baked["rgb_mlp"]])
    out["brick"] = dp.render_brick_dp(baked, bcfg_model, t(o), t(d), W, H,
                                      bcfg=bcfg, device="cpu", **kw)
    return out


# --------------------------------------------------- test_torch_multiscene


def multiscene_cases(trees, scenes, cfg, draws):
    """Rank s trains scene s: the states handed out from rank 0's list
    (scatter_states), len(draws) multi-scene steps on per-scene draws
    (draws[i][s]); returns every step's per-scene metrics and the
    gathered states."""
    from google_nerf_tpu_torch.parallel.multiscene import (
        gather_states, make_multiscene_train_step, scatter_states)
    rank = comm.get_rank()
    st = scatter_states(trees if rank == 0 else None, cfg, device="cpu")
    sc = tree_t(scenes[rank])
    step = make_multiscene_train_step(cfg)
    metrics = []
    for d in draws:
        st, m = step(st, sc, draws={k: t(v) for k, v in d[rank].items()})
        metrics.append(m)
    return dict(metrics=metrics, states=gather_states(st))


# ------------------------------------------------ test_torch_depth_parallel


def syncbn_cases(state, cfg, rgb, weight):
    """SyncBN on this rank's share of the global batch: the train-mode
    forward in float32 and float64 and the running statistics after it;
    in float64 the gradients of sum(logit * weight) with respect to this
    rank's images and the params (summed over the ranks)."""
    import dataclasses

    from google_nerf_tpu_torch.depth.model import DepthNet
    n, rank = comm.get_world_size(), comm.get_rank()
    b = rgb.shape[0] // n
    sl = slice(rank * b, (rank + 1) * b)
    out = {}
    for dt in (torch.float32, torch.float64):
        model = DepthNet(dataclasses.replace(cfg, bn_axis_name="data"))
        model.load_state_dict({k: t(v) for k, v in state.items()})
        model = model.to(dt).train()
        x = t(rgb[sl]).to(dt).requires_grad_(dt == torch.float64)
        y = model(x)
        key = str(dt).split(".")[1]
        out[f"logit_{key}"] = y.detach()
        out[f"stats_{key}"] = {k: v.clone() for k, v in
                               model.state_dict().items()
                               if "running" in k}
        if dt == torch.float64:
            (y * t(weight[sl]).to(dt)).sum().backward()
            out["grad_x"] = x.grad
            grads = {k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None}
            for g in grads.values():
                torch.distributed.all_reduce(g)
            out["grads"] = grads
    return out


# --------------------------------------------------------- test_torch_cli_dp


def cli_cases(root, train_argv, serve_argvs):
    """train_torch.main at --num_gpus 2 in this world (torchrun's
    environment set by hand; the group is the world's), then
    test_torch.run --num_gpus 2 on its slim checkpoint for each serving
    argv.  Returns the validation logs, the state's params as validate
    saw them, and each serve's result."""
    import test_torch
    import train_torch
    from google_nerf_tpu_torch.opt import get_opts
    from google_nerf_tpu_torch.utils import logging as tlog
    os.environ.update(WORLD_SIZE=str(comm.get_world_size()),
                      RANK=str(comm.get_rank()),
                      LOCAL_RANK=str(comm.get_rank()),
                      GNT_TORCH_GT_CACHE=os.path.join(root, "gt"))
    os.chdir(root)
    tlog.USE_TENSORBOARD = False
    seen = {}
    validate = train_torch.validate

    def keep(hparams, cfg, state, *a, **k):
        seen.update({n: v.detach().clone() for n, v in
                     state["params"].items() if torch.is_tensor(v)})
        return validate(hparams, cfg, state, *a, **k)

    train_torch.validate = keep
    try:
        logs = train_torch.main(get_opts(train_argv))
    finally:
        train_torch.validate = validate
    served = [test_torch.run(get_opts(a)) for a in serve_argvs]
    return dict(logs=logs, params=seen, served=served)


# ------------------------------------------------------------- the launcher


def _fails_on_rank_1():
    comm.synchronize()
    if comm.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(60)              # rank 0 is still at work when rank 1 fails
    return 0


def _sleeps(seconds):
    time.sleep(seconds)
    return comm.get_rank()


def test_a_failed_rank_fails_the_world_at_once():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_world(_fails_on_rank_1, 2, timeout=60)
    assert time.time() - t0 < 50


def test_a_world_past_its_timeout_is_killed():
    with pytest.raises(TimeoutError, match="did not finish"):
        run_world(_sleeps, 2, (60,), timeout=8)
    assert run_world(_sleeps, 2, (0,), timeout=60) == [0, 1]


def test_init_distributed_outside_torchrun(monkeypatch):
    """Without torchrun's WORLD_SIZE: a world of one and no group (JAX's
    single-host no-op).  With it but no MASTER_ADDR, the join raises: no
    fallback to one device."""
    from google_nerf_tpu_torch.parallel.dp import init_distributed
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed(device_type="cpu") == (0, torch.device("cpu"))
    assert not comm.initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(device_type="cpu")
    assert not comm.initialized()


def test_init_distributed_defaults_to_the_card(monkeypatch):
    """device_type defaults to "cuda", and without a card that raises
    rather than quietly joining on the CPU."""
    from google_nerf_tpu_torch.parallel.dp import init_distributed
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_distributed()
    assert init_distributed(device_type="cpu") == (0, torch.device("cpu"))
    assert not comm.initialized()


def test_comm_answers_for_a_world_of_one():
    """Without a process group: world 1, rank 0, the main process, no
    barrier, a one-element gather and reduce_dict's identity (JAX's
    single-host answers, tests/test_depth_parallel.py)."""
    assert not comm.initialized()
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.is_main_process()
    comm.synchronize()
    assert comm.all_gather_objects({"x": 1}) == [{"x": 1}]
    x = torch.arange(4.0)
    assert torch.equal(comm.all_gather_cat(x), x)
    d = comm.reduce_dict({"a": x.sum(), "b": 2.0})
    assert float(d["a"]) == 6.0 and float(d["b"]) == 2.0
    assert float(comm.reduce_loss_dict({"a": x.sum()})["a"]) == 6.0
