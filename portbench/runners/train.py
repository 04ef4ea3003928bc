"""Training traffic: the program's training system
(`train/system.run_training`) on the benchmark's procedural captures.

Set-up builds one training state from weights the benchmark makes on
the device from the seed, drives its first three steps one call each
(reading each step's loss, the first gradient from Adam's first moment
and, after the third, each leaf's change), then the rest of the
traffic's set-up steps.  The window runs steps, the grid cadence
included, from one synchronise to the next, with none between.  Right
after it one more call of one step runs a post-warm-up grid update;
the parameters, grid and generator state before it and the grid after
it are kept.  With --trace a profiled slice of steps follows.  Then
the program's state is freed and the plain reference
(reference/train.py) follows the same three first steps on the same
draws, and the same grid update from the kept state (the program's
parameters after its set-up and window: both sides are fed state the
program made there).
"""
from __future__ import annotations

import time

import torch

from portbench.lib import common, compare, program, scene, spans, work
from portbench.reference import field as rf
from portbench.reference import train as rt

BETA1 = 0.9


def _faults(fault, tsys):
    """Patches that break the timed path (calibration and tests)."""
    if fault is None:
        return []
    if fault == "frozen":          # the step leaves the state unchanged
        new = {"apply_grads": lambda state, grads, cfg: 0.0}
    elif fault == "half_batch":    # half the rays left out of the mean
        base = tsys.NeRFLoss

        class Half(base):
            def total(self, results, batch):
                m = results["ray_mask"].clone()
                m[m.shape[0] // 2:] = False
                return base.total(self, dict(results, ray_mask=m), batch)
        new = {"NeRFLoss": Half}
    elif fault == "grid_frozen":   # the grid update leaves the grid
        return []                  # (planted in _grid_step alone)
    elif fault == "altered":       # one leaf's gradient altered
        base_apply = tsys.apply_grads

        def altered(state, grads, cfg):
            grads = dict(grads)
            grads["rgb_mlp.1"] = grads["rgb_mlp.1"] * 1.05
            return base_apply(state, grads, cfg)
        new = {"apply_grads": altered}
    else:
        raise ValueError(f"unknown fault {fault!r}")
    old = {k: getattr(tsys, k) for k in new}
    for k, v in new.items():
        setattr(tsys, k, v)
    return [(tsys, old)]


def _first_steps(tsys, state, scene_p, cfg, gen, snap, names):
    """Steps 1-3 through run_training: losses, the first gradient (Adam's
    first moment after one step over 1 - beta1) and each leaf's change
    after three steps, by the benchmark's leaf names."""
    leaves = tsys.param_leaves(state["params"])
    losses, g1 = [], {}
    for i in range(3):
        _, m = tsys.run_training(state, scene_p, cfg, steps=1,
                                 generator=gen)
        losses.append(m["loss"].detach().clone())
        if i == 0:
            for b, p in names.items():
                st = state["opt"].state.get(leaves[p], {})
                g1[b] = (st["exp_avg"] / (1 - BETA1) if "exp_avg" in st
                         else torch.zeros_like(leaves[p])).detach().clone()
    d3 = {b: (leaves[p].detach() - snap[b]).clone() for b, p in names.items()}
    return losses, g1, d3


def _reference(spec, recipe, sc, snap, prec, G, gen_state, dev):
    """Losses, first gradient and change of three reference steps."""
    ref = rt.TrainReference(spec, recipe, sc, _as_params(spec, snap), prec, G)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    losses, g1 = [], None
    for i in range(3):
        loss, grads = ref.train_step(gen)
        losses.append(float(loss))
        if i == 0:
            g1 = {k: g.detach() for k, g in grads.items()}
    names = rt.leaf_names(spec)
    now = dict(zip(names, ref.leaves()))
    d3 = {k: (now[k].detach() - snap[k]) for k in names}
    return losses, g1, d3


def _grid_step(tsys, state, scene_p, cfg, gen, names, frozen: bool):
    """One call of one step at a post-warm-up grid update: the
    parameters (benchmark names), grid and generator state before it,
    and the grid and occupancy after it."""
    step = state["step"]
    if step % cfg.grid_update_interval or step < cfg.warmup_steps:
        raise RuntimeError(f"step {step} runs no post-warm-up grid update")
    leaves = tsys.param_leaves(state["params"])
    kept = dict(params={b: leaves[p].detach().clone()
                        for b, p in names.items()},
                grid=state["density_grid"].reshape(-1).clone(),
                gen=gen.get_state())
    old = tsys.grid_update_step
    if frozen:
        tsys.grid_update_step = lambda state, cfg, **kw: state
    try:
        tsys.run_training(state, scene_p, cfg, steps=1, generator=gen)
    finally:
        tsys.grid_update_step = old
    kept.update(after=state["density_grid"].reshape(-1).clone(),
                occ=state["occ"].reshape(-1).clone())
    return kept


def _grid_reference(spec, recipe, kept, prec, G, dev):
    """The reference's grid update from the kept state and draws."""
    field = rf.Field(spec, _as_params(spec, kept["params"]), prec)
    gen = torch.Generator(device=dev)
    gen.set_state(kept["gen"])
    return rt.update_grid(kept["grid"], field, recipe, G, spec.scale,
                          False, gen)


def grid_readings(grid, occ, ref_grid, ref_occ):
    """grid_gap: the norm of the grid's difference over the reference's
    norm, over the cells that are not dead (-1); occ_flips: cells whose
    occupancy differs."""
    live = ref_grid >= 0
    d = (grid[live].double() - ref_grid[live].double()).norm()
    gap = float(d / ref_grid[live].double().norm().clamp_min(1e-30))
    flips = int((occ != ref_occ).sum())
    common.say(f"grid update: gap {gap:.6g}, occupancy flips {flips} of "
               f"{int(ref_occ.sum())} occupied")
    return dict(grid_gap=gap, occ_flips=flips)


def _as_params(spec, flat):
    names = rt.leaf_names(spec)
    ns = len(spec.sigma_dims) - 1
    return dict(table=flat["table"],
                sigma_mlp=[flat[k] for k in names[1:1 + ns]],
                rgb_mlp=[flat[k] for k in names[1 + ns:]])


def readings(prog, ref):
    """loss_gap (worst step), grad_gap (worst leaf of the first
    gradient), update_gap (worst moved leaf of the change after three
    steps)."""
    (pl, pg, pd), (rl, rg, rd) = prog, ref
    loss_gap = max(compare.rel_gap(float(a), b) for a, b in zip(pl, rl))
    grad_gap, g_leaf = compare.leaf_norm_gap(pg, rg)
    moved = compare.moved_leaves(rg)
    upd_gap, u_leaf = compare.leaf_norm_gap(pd, rd, moved)
    common.say("losses program", [float(x) for x in pl], "reference", rl)
    common.say("grad gap per leaf", g_leaf)
    common.say("update gap per leaf", u_leaf, "moved", moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, update_gap=upd_gap)


def run(cell, *, seed, seconds, trace, device, fault=None, control=False):
    start = common.t0()
    dev = torch.device(device)
    conf, tr = cell.config, cell.traffic
    rec = tr["recipe"]
    prec = rf.precision_of(conf["precision"], False)
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    spec = rf.field_spec(conf["model"])
    recipe = rt.Recipe(rec)
    G = conf["model"]["grid_size"]
    common.say(f"program and torch ready at {time.perf_counter() - start:.3f} s")
    sc = scene.training_scene(tr["scene"]["views"], tr["scene"]["width"],
                              tr["scene"]["height"], dev)
    scene_p = {k: sc[k] for k in ("images", "alphas", "poses",
                                  "directions")}
    common.sync(dev)
    common.say(f"scene made at {time.perf_counter() - start:.3f} s")
    p0 = rf.make_params(spec, seed, dev)
    snap = {k: v.detach().clone() for k, v in rf.leaves(p0).items()}
    gen = torch.Generator(device=dev).manual_seed(
        (2 * int(seed) + 1) % (1 << 63))
    gen_state = gen.get_state()
    out = dict(attempted=0, failed=0, spec=spec, gather=prec.gather,
               recipe=rec, dtype=conf["precision"]["compute"],
               tf32=prec.tf32)
    from google_nerf_tpu_torch.train import system as tsys
    cfg = program.train_config(conf["model"], rec)
    program.check_layout(cfg.model, spec, rec)
    patched = _faults(fault, tsys)
    try:
        state = tsys.init_train_state(
            cfg, sc["K"], sc["poses_np"], sc["img_wh"],
            params=program.program_params(spec, p0), device=dev)
        common.sync(dev)
        common.say(f"state built at {time.perf_counter() - start:.3f} s")
        names = {b: program.leaf_map(spec).get(b, b) for b in snap}
        prog = _first_steps(tsys, state, scene_p, cfg, gen, snap, names)
        common.sync(dev)
        common.say(f"first steps read at {time.perf_counter() - start:.3f} s")
        tsys.run_training(state, scene_p, cfg, steps=tr["setup_steps"] - 3,
                          generator=gen)
        common.sync(dev)
        t_w = time.perf_counter()
        out["setup_s"] = t_w - start
        chunk = cfg.grid_update_interval
        step0, steps = state["step"], 0
        marks = []
        while True:
            _, m = tsys.run_training(state, scene_p, cfg, steps=chunk,
                                     generator=gen)
            steps += chunk
            marks.append(time.perf_counter() - t_w)
            if marks[-1] >= seconds:
                break
        common.sync(dev)
        out["window_s"] = time.perf_counter() - t_w
        out["steps"] = steps
        out["rays"] = steps * cfg.batch_size
        out["attempted"] = steps
        out["failed"] = int(not bool(torch.isfinite(m["loss"])))
        grid_updates = sum(1 for s in range(step0, step0 + steps)
                           if s % cfg.grid_update_interval == 0)
        grid = _grid_step(tsys, state, scene_p, cfg, gen, names,
                          fault == "grid_frozen")
        if trace:
            n = tr["trace_steps"]
            with spans.layer_ranges(program.TABLE_KEY[spec.encoder]):
                t = common.traced(lambda: tsys.run_training(
                    state, scene_p, cfg, steps=n, generator=gen), dev)
            fwd = t.launched_in(t.ranges(spans.ENC_FWD, exclude=spans.GRID))
            bwd = t.launched_in(t.ranges(spans.ENC_BWD))
            out["trace"] = dict(
                window_s=t.window_s, busy_s=t.busy_s, steps=n,
                launches=t.launches(),
                enc_fwd_s=t.device_seconds(fwd) if fwd else None,
                enc_bwd_s=t.device_seconds(bwd) if bwd else None)
            out["breakdown"] = common.breakdown(t)
            # the samples a step evaluates: the budget, unless the
            # reference's march of a fresh batch on the program's final
            # occupancy finds fewer
            kept = _reference_samples(sc, state["occ"], recipe, spec, G,
                                      seed, dev)
            out["samples_per_step"] = min(cfg.samples_budget, kept)
            out["flops"] = (steps * work.train_step_flops(
                spec, out["samples_per_step"]) + grid_updates
                * work.density_flops(spec, 2 * G ** 3 // cfg.grid_sample_div))
            common.say("samples a step: budget", cfg.samples_budget,
                       "reference march", kept)
        out["device"] = common.device_block(dev)
        if trace:
            out["device"].update(busy_s=out["trace"]["busy_s"],
                                 window_s=out["trace"]["window_s"])
        per = sorted(1e3 * (b - a) / chunk
                     for a, b in zip([0.0] + marks[:-1], marks))
        common.say(f"host ms a step over {len(per)} chunks of {chunk}: min "
                   f"{per[0]:.2f}, median {per[len(per) // 2]:.2f}, max "
                   f"{per[-1]:.2f}")
        common.say(f"setup {out['setup_s']:.3f} s, {steps} steps in "
                   f"{out['window_s']:.3f} s; card", common.card_line()
                   if dev.type == "cuda" else "cpu")
    finally:
        for mod, old in patched:
            for k, v in old.items():
                setattr(mod, k, v)
    del state, p0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(spec, recipe, sc, snap, prec, G, gen_state, dev)
    ref_grid = _grid_reference(spec, recipe, grid, prec, G, dev)
    if control:
        # the reference in the control precision in the program's place
        cprec = rf.precision_of(conf["precision"], True)
        prog = _reference(spec, recipe, sc, snap, cprec, G, gen_state, dev)
        grid["after"], grid["occ"] = _grid_reference(spec, recipe, grid,
                                                     cprec, G, dev)
        out["metrics_skip"] = True
    out["readings"] = dict(readings(prog, ref), **grid_readings(
        grid["after"], grid["occ"], *ref_grid))
    return out


@torch.no_grad()
def _reference_samples(sc, occ, recipe, spec, G, seed, dev):
    """Samples the reference's march finds for one batch of the traffic
    on a given occupancy (its own draws)."""
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 62) + 7)
    n_img, n_pix = sc["images"].shape[:2]
    img = torch.randint(0, n_img, (recipe.batch,), generator=g, device=dev)
    pix = torch.randint(0, n_pix, (recipe.batch,), generator=g, device=dev)
    noise = torch.rand((recipe.batch,), generator=g, device=dev)
    o, d = rt.batch_rays(sc, img, pix)
    du = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    t1, t2 = rt.aabb_hits(o, du, spec.scale)
    _, valid, _ = rt.march(o, du, t1, t2, occ.reshape(1, G, G, G), noise,
                           recipe, spec.scale, G)
    return int(valid.sum())
