"""The port's depth optimizer (google_nerf_tpu_torch/depth/optim.py)
against JAX's optax chain (google_nerf_tpu/depth/optim.py) on the CPU:

  * warmup_multistep_lr at steps 0, 1, 250, 499, 500, 501 and each
    milestone and its neighbours, both warmup methods: rtol 1e-7 (both
    compute it in float32, in one order);
  * the parameter groups: for resnet18, resnet50 and resnext101_32x8d,
    AdaIN at the encoder and at the decoder, the port's group of every
    tensor (JAX's rule on the flax path convert.depth_flax_path gives)
    equals the label JAX's rule gives that path, with the same set of
    paths; and each tensor's learning rate, with and without a frozen
    backbone, equals the one optax applies to it (read off one optax
    update of weight decay alone on a tree of one-element leaves);
  * three updates of a resnet18 cIMLE DepthNet from the same gradients,
    once with the clip active and once not, with the warmup schedule
    moving, both sides in float64 (optax under jax.enable_x64): each
    update's parameter change (after minus before) and the momentum
    traces, each tensor norm-relative 1e-6.  In float32 the change
    could not be read to that bound: it is ~1e-4 of the parameters, whose
    own rounding then shows."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from google_nerf_tpu.depth import optim as jopt
from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import init_depth_model as jax_init
from google_nerf_tpu_torch.convert import (depth_flax_path, depth_n_convs,
                                           depth_state_to_jax)
from google_nerf_tpu_torch.depth import optim as topt
from google_nerf_tpu_torch.depth.model import (DepthModelConfig, DepthNet,
                                               init_depth_model)

MILESTONES = (120000, 200000)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these networks are small, and the test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedule_matches_jax(method):
    kw = dict(milestones=MILESTONES, warmup_iters=500, warmup_method=method)
    jsched = jopt.warmup_multistep_lr(1.0, **kw)
    tsched = topt.warmup_multistep_lr(1.0, **kw)
    steps = [0, 1, 250, 499, 500, 501] + [m + d for m in MILESTONES
                                          for d in (-1, 0, 1)]
    for s in steps:
        want = float(jsched(jnp.asarray(s, jnp.int32)))
        assert tsched(s) == pytest.approx(want, rel=1e-7, abs=0), (s, want)
    j2 = jopt.warmup_multistep_lr(0.02, (3, 5), gamma=0.5, warmup_iters=4,
                                  warmup_method=method)
    t2 = topt.warmup_multistep_lr(0.02, (3, 5), gamma=0.5, warmup_iters=4,
                                  warmup_method=method)
    for s in range(8):
        assert t2(s) == pytest.approx(float(j2(jnp.asarray(s, jnp.int32))),
                                      rel=1e-7, abs=0)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50",
                                      "resnext101_32x8d"])
@pytest.mark.parametrize("site", ["encoder", "decoder"])
def test_groups_and_learning_rates_match_jax(backbone, site):
    kw = dict(backbone=backbone, d_latent=8, cimle_site=site)
    shapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                             JConfig(**kw), (32, 32)))
    jlabels = jax.tree_util.tree_map_with_path(
        lambda path, _: jopt._param_group(path), shapes["params"])
    want = dict(_paths(jlabels))
    with torch.device("meta"):
        model = DepthNet(DepthModelConfig(**kw))
    groups = topt.param_groups(model)
    named = dict(model.named_parameters())
    n_convs = depth_n_convs(named)
    got = {depth_flax_path(k, p.ndim, n_convs)[1]: groups[k]
           for k, p in named.items()}
    assert got == want
    assert {"encoder", "decoder", "style"} == set(want.values())

    # each tensor's learning rate: optax's update of weight decay alone
    # (zero gradients, params 1) is -lr * 5e-4
    ones = jax.tree_util.tree_map(lambda _: jnp.ones((1,)), shapes["params"])
    for frozen in (False, True):
        tx = jopt.make_depth_optimizer(ones, 0.02, scale_decoder_lr=3.0,
                                       mlp_lr=0.5, fixed_backbone=frozen)
        upd, _ = tx.update(jax.tree_util.tree_map(jnp.zeros_like, ones),
                           tx.init(ones), ones)
        jlr = {p: -float(u[0]) / 5e-4 for p, u in _paths(upd)}
        opt = topt.make_depth_optimizer(model, 0.02, scale_decoder_lr=3.0,
                                        mlp_lr=0.5, fixed_backbone=frozen)
        for k, p in named.items():
            path = depth_flax_path(k, p.ndim, n_convs)[1]
            assert opt.lr(groups[k]) == pytest.approx(jlr[path], rel=1e-6,
                                                      abs=1e-12), (k, frozen)


def _close(got, want, what):
    """Norm-relative 1e-6."""
    err = float(np.linalg.norm(got - want))
    assert err <= 1e-6 * float(np.linalg.norm(want)), (what, err)


def _to_jax_tree(named):
    """{port param name: tensor} -> flax params tree (numpy)."""
    return depth_state_to_jax(named)["params"]


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_three_updates_match_optax(clip):
    cfg = DepthModelConfig(backbone="resnet18", d_latent=8)
    model = init_depth_model(torch.Generator().manual_seed(0), cfg,
                             "cpu").double()
    named = dict(model.named_parameters())
    sched_kw = dict(milestones=(2,), warmup_iters=2)
    opt = topt.make_depth_optimizer(
        model, 0.01, scale_decoder_lr=2.0, mlp_lr=0.05,
        schedule=topt.warmup_multistep_lr(1.0, **sched_kw))
    rng = np.random.default_rng(3)
    scale = 3e-3 if clip == "active" else 1e-5
    with jax.enable_x64(True):
        jparams = jax.tree_util.tree_map(jnp.asarray, _to_jax_tree(
            {k: p.detach() for k, p in named.items()}))
        tx = jopt.make_depth_optimizer(
            jparams, 0.01, scale_decoder_lr=2.0, mlp_lr=0.05,
            schedule=jopt.warmup_multistep_lr(1.0, **sched_kw))
        jstate = tx.init(jparams)
        update = jax.jit(tx.update)
        for step in range(3):
            grads = {k: torch.from_numpy(rng.normal(0, scale, p.shape))
                     for k, p in named.items()}
            norm = float(torch.sqrt(sum((g * g).sum()
                                        for g in grads.values())))
            assert (norm > 10.0) == (clip == "active"), norm
            before = {k: p.detach().clone() for k, p in named.items()}
            for k, p in named.items():
                p.grad = grads[k].clone()
            opt.step()
            jg = jax.tree_util.tree_map(jnp.asarray, _to_jax_tree(grads))
            upd, jstate = update(jg, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            want = dict(_paths(jax.tree_util.tree_map(np.asarray, upd)))
            got = dict(_paths(_to_jax_tree(
                {k: p.detach() - before[k] for k, p in named.items()})))
            assert got.keys() == want.keys()
            assert all(v.dtype == np.float64 for v in want.values())
            for path in want:
                _close(got[path], want[path], str((step, path)))
    # the momentum traces, per group
    traces = {}
    for inner in jstate[1].inner_states.values():
        for path, v in _paths(inner.inner_state[1][0].trace):
            if isinstance(v, jnp.ndarray):       # not a MaskedNode
                traces[path] = np.asarray(v)
    got = dict(_paths(_to_jax_tree({k: opt.state[p]["trace"]
                                    for k, p in named.items()})))
    assert got.keys() == traces.keys()
    for path in traces:
        _close(got[path], traces[path], str(path))
    assert all(g["count"] == 3 for g in opt.param_groups)
