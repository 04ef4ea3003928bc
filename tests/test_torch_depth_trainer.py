"""The port's cIMLE depth trainer (google_nerf_tpu_torch/depth/trainer.py,
train-mode BatchNorm, convert.depth_train_state_from_jax) against JAX's
(google_nerf_tpu/depth/trainer.py) on the CPU, at resnet18, 64x64,
batch 2, encoder-site AdaIN at d_latent 8, the CLI's default loss mode,
on a dataset the tests write:

  * a train-mode forward against flax's with mutable batch_stats: the
    logit norm-relative 1e-5, the new batch_stats rtol 1e-5 (atol 1e-6);
  * the z-cache's (B, M) total_raw against JAX's make_zcache_fn on JAX's
    loss draws: rtol 1e-5, the same argmin per image;
  * three train steps from one JAX state carried across after a first
    JAX step (its momentum traces and count nonzero), on JAX's batches,
    latents and loss draws: the loss rtol 1e-5 each step; every kernel
    and BatchNorm scale norm-relative 1e-4, the biases 5e-3 (below);
    batch_stats norm-relative 1e-5;
  * calibrate_adain against JAX's on JAX's latents: the shifts rtol 1e-5
    (atol 1e-6);
  * tests/test_depth_trainer.py's smoke run (6 steps, finite, not
    diverging) and resume round trip, in the port's own checkpoint
    format.

Float32 lies far from float64 in a train step of these networks at a
batch of 2 at 64x64 (most of it in train-mode BatchNorm's backward
pass, PERF.md section 6): flax's float32 forward is 8.4e-5 from its own
float64 forward (the port's ~2e-6), and JAX's float32 gradients miss
its float64 ones by up to 2e-2 on some BatchNorm biases.  So the
train-mode forward and the steps are held to JAX run in float64
(jax.enable_x64; its loss draws made in float32, the draws the port is
given), which the port's step in float64 meets within 1e-6.  The
biases start at zero and their three updates are sums of
near-cancelling terms, so
float32 leaves them 1.6e-3 from float64 (JAX's float32 run as the
port's): 5e-3.  The biases of convolutions that feed a BatchNorm have a
zero gradient in exact arithmetic; their float32 values are rounding
noise and are held below 1e-9.

JAX's state is built as its init_trainer builds it, on the port's init
carried across (JAX's init is not under test); its programs are
compiled once each."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.depth import model as jmodel
from google_nerf_tpu.depth import optim as jopt
from google_nerf_tpu.depth import trainer as jtrainer
from google_nerf_tpu.depth.config import DepthCfg as JDepthCfg
from google_nerf_tpu.depth.data import DepthAnnotationDataset as JDataset
from google_nerf_tpu.depth.data import MultiDatasetSampler as JSampler
from google_nerf_tpu.depth.model import DepthNet as JNet
from google_nerf_tpu_torch.convert import (depth_flax_path, depth_n_convs,
                                           depth_state_from_jax,
                                           depth_state_to_jax,
                                           depth_train_state_from_jax)
from google_nerf_tpu_torch.depth import trainer
from google_nerf_tpu_torch.depth.config import DepthCfg
from google_nerf_tpu_torch.depth.data import (DepthAnnotationDataset,
                                              MultiDatasetSampler)
from google_nerf_tpu_torch.depth.model import DepthNet
from google_nerf_tpu_torch.utils.ckpt import load_ckpt, save_ckpt
from test_torch_depth_data import write_dataset
from test_torch_depth_losses import jax_loss_draws

HW = 64
LATENT = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these networks are small, and the test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls, **train):
    cfg = cls()
    train = dict(dict(batch_size=2, num_latent=4, latent_minibatch=2),
                 **train)
    return dataclasses.replace(
        cfg,
        dataset=dataclasses.replace(cfg.dataset, crop_size=(HW, HW)),
        model=dataclasses.replace(cfg.model, encoder="resnet18",
                                  d_latent=LATENT, cimle_version="v2"),
        train=dataclasses.replace(cfg.train, **train))


@contextlib.contextmanager
def jax_float64(monkeypatch):
    """JAX in float64, its Gumbel and randint draws made as in float32
    (the bits jax_loss_draws hands the port)."""
    gumbel, randint = jax.random.gumbel, jax.random.randint
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda k, shape=(), dtype=None: gumbel(
                            k, shape, jnp.float32).astype(jnp.float64))
    monkeypatch.setattr(jax.random, "randint",
                        lambda k, shape, lo, hi, dtype=None: randint(
                            k, shape, lo, hi, jnp.int32))
    try:
        with jax.enable_x64(True):
            yield
    finally:
        monkeypatch.undo()


def _f64(tree):
    """numpy tree -> JAX float64 arrays (integers kept)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _bn_fed(model):
    """The flax paths of trainer.bn_fed_biases(model): zero gradient."""
    named = dict(model.named_parameters())
    n_convs = depth_n_convs(named)
    return {depth_flax_path(k, 1, n_convs)[1]
            for k in trainer.bn_fed_biases(model)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The dataset, both configs, and JAX's trainer state (variables,
    optax state, tx as JAX's init_trainer builds them) on the port's
    init carried across (JAX's own init is not under test)."""
    root = str(tmp_path_factory.mktemp("depth_trainer"))
    write_dataset(root, "demo", n=6, hw=(72, 80))
    jcfg, tcfg = _cfg(JDepthCfg), _cfg(DepthCfg)
    model = trainer.init_trainer(0, tcfg, "cpu")[0].model
    variables = jax.tree_util.tree_map(
        jnp.asarray, depth_state_to_jax(model.state_dict()))
    t = jcfg.train
    tx = jopt.make_depth_optimizer(
        variables["params"], t.base_lr, scale_decoder_lr=t.scale_decoder_lr,
        mlp_lr=t.mlp_lr, fixed_backbone=jcfg.model.freeze_backbone,
        schedule=jopt.warmup_multistep_lr(1.0, t.lr_milestones,
                                          warmup_iters=t.warmup_iters))
    jstate = jtrainer.DepthTrainState(variables,
                                      tx.init(variables["params"]))
    mcfg, jlcfg = jtrainer.model_config(jcfg), jtrainer.loss_config(jcfg)
    jsampler = JSampler([JDataset(root, "demo", cfg=jcfg.dataset)])
    tsampler = MultiDatasetSampler([DepthAnnotationDataset(
        root, "demo", cfg=tcfg.dataset)])
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, jstate=jstate, tx=tx,
                mcfg=mcfg, jlcfg=jlcfg, jsampler=jsampler,
                tsampler=tsampler,
                zcache=jtrainer.make_zcache_fn(mcfg, jlcfg),
                batches=list(jsampler.batches(0, 2)))


def _port_model(world, variables):
    model = DepthNet(trainer.model_config(world["tcfg"])).eval()
    model.load_state_dict(depth_state_from_jax(_np(variables)))
    return model


def _latents(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, LATENT)).astype(np.float32)


def test_train_mode_batchnorm_matches_flax(world, monkeypatch):
    variables = world["jstate"].variables
    batch = world["batches"][0]
    z = _latents(2, 1)
    with jax_float64(monkeypatch):
        logit, upd = jax.jit(lambda v, x, zz: JNet(world["mcfg"]).apply(
            v, x, z=zz, train=True, mutable=["batch_stats"]))(
                _f64(_np(variables)), _f64(batch["rgb"]), _f64(z))
        logit, upd = np.asarray(logit), _np(upd)
    model = _port_model(world, variables).train()
    data = trainer.batch_to_device(batch, "cpu")
    with torch.no_grad():
        out = model(data["rgb"], torch.from_numpy(z))
    assert _rel(out.numpy().transpose(0, 2, 3, 1), logit) <= 1e-5
    got = dict(_flat(depth_state_to_jax(model.state_dict())["batch_stats"]))
    want = dict(_flat(_np(upd["batch_stats"])))
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=str(k))
        moved += k[-1] == "var" and not np.allclose(want[k], 1.0)
    assert moved > 10                 # the biased variance, not the 1s
    assert all(int(b.num_batches_tracked) == 1 for b in model.modules()
               if isinstance(b, torch.nn.BatchNorm2d))


def test_zcache_matches_jax(world):
    batch = world["batches"][1]
    b, m = 2, 3
    z = _latents(b * m, 2).reshape(b, m, LATENT)
    key = jax.random.PRNGKey(5)
    want = np.asarray(world["zcache"](
        world["jstate"].variables,
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z), key))
    model = _port_model(world, world["jstate"].variables)
    got = trainer.zcache_losses(
        model, trainer.loss_config(world["tcfg"]),
        trainer.batch_to_device(batch, "cpu"), torch.from_numpy(z),
        draws=jax_loss_draws(key, b * m, HW, HW)).numpy()
    assert got.shape == (b, m)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))
    assert np.ptp(want, axis=1).min() > 1e-4        # the latents matter


def test_three_train_steps_match_jax(world, monkeypatch):
    """One JAX step, the state carried across (in float32), then three
    steps each: the port in float32 against JAX in float64 from the same
    state, and the port's first step in float64 against JAX's (the same
    function: 1e-6)."""
    key = jax.random.PRNGKey(9)
    z = _latents(2, 3)
    keys = [jax.random.fold_in(key, s) for s in range(4)]
    batches = [world["batches"][s % 3] for s in range(4)]
    draws = [jax_loss_draws(k, 2, HW, HW) for k in keys[1:]]
    with jax_float64(monkeypatch):
        step64 = jtrainer.make_train_step(world["tx"], world["mcfg"],
                                          world["jlcfg"])
        jv, jo, _ = step64(_f64(_np(world["jstate"].variables)),
                           _f64(_np(world["jstate"].opt_state)),
                           _f64(batches[0]), _f64(z), keys[0])
        start = jax.tree_util.tree_map(
            lambda a: np.asarray(a).astype(np.float32)
            if np.asarray(a).dtype == np.float64 else np.asarray(a),
            (jv, jo))
        jv, jo = _f64(start[0]), _f64(start[1])
        jloss, after = [], []
        for k, bt in zip(keys[1:], batches[1:]):
            jv, jo, jsc = step64(jv, jo, _f64(bt), _f64(z), k)
            jloss.append({n: float(v) for n, v in jsc.items()})
            after.append(_np(jv))
    lcfg = trainer.loss_config(world["tcfg"])

    def port(dtype, n_steps):
        state = depth_train_state_from_jax(*start, 1, world["tcfg"])
        assert state.step == 1
        assert all(g["count"] == 1 for g in state.optimizer.param_groups)
        state.model.to(dtype)
        for p in state.model.parameters():
            tr = state.optimizer.state[p]
            tr["trace"] = tr["trace"].to(dtype)
        losses = []
        for bt, dr in list(zip(batches[1:], draws))[:n_steps]:
            data = {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in trainer.batch_to_device(bt, "cpu").items()}
            cast = {name: {k: v.to(dtype) if v.is_floating_point() else v
                           for k, v in d.items()} for name, d in dr.items()}
            sc = trainer.train_step(state, data, torch.from_numpy(z).to(
                dtype), lcfg, draws=cast)
            losses.append({k: float(v) for k, v in sc.items()})
        assert state.step == 1 + n_steps
        return depth_state_to_jax(state.model.state_dict()), losses, \
            _bn_fed(state.model)

    got32, loss32, bn_fed = port(torch.float32, 3)
    assert len(bn_fed) == 8          # 7 FTBs' conv_branch.1, AO's conv
    got64, _, _ = port(torch.float64, 1)       # the same function
    for tsc, jsc in zip(loss32, jloss):
        assert set(tsc) == set(jsc)
        for name in jsc:
            assert tsc[name] == pytest.approx(jsc[name], rel=1e-5,
                                              abs=1e-7), name
    for coll in ("params", "batch_stats"):
        w, w1 = dict(_flat(after[-1][coll])), dict(_flat(after[0][coll]))
        g32, g64 = dict(_flat(got32[coll])), dict(_flat(got64[coll]))
        assert g32.keys() == w.keys() == g64.keys()
        for path in w:
            if path in bn_fed:
                assert np.abs(g32[path]).max() <= 1e-9, path
                continue
            assert _rel(g64[path], w1[path]) <= 1e-6, path
            bound = (1e-5 if coll == "batch_stats" else
                     5e-3 if path[-1] == "bias" else 1e-4)
            assert _rel(g32[path], w[path]) <= bound, path


def test_calibrate_adain_matches_jax(world, monkeypatch):
    key = jax.random.PRNGKey(4)
    monkeypatch.setattr(jmodel, "get_adain_init_act", jax.jit(
        jmodel.get_adain_init_act, static_argnums=1))
    jstate = jtrainer.DepthTrainState(world["jstate"].variables,
                                      world["jstate"].opt_state)
    jstate = jtrainer.calibrate_adain(key, jstate, world["jsampler"],
                                      world["jcfg"], world["mcfg"],
                                      n_batches=2, n_z=2)
    state, _ = trainer.init_trainer(0, world["tcfg"], "cpu")
    state.model.load_state_dict(depth_state_from_jax(
        _np(world["jstate"].variables)))

    def latents(b, zi):
        return np.asarray(jax.random.normal(
            jax.random.fold_in(key, b * 100 + zi), (1, LATENT)))

    trainer.calibrate_adain(0, state, world["tsampler"], world["tcfg"],
                            n_batches=2, n_z=2, latents=latents)
    got = dict(_flat(depth_state_to_jax(
        state.model.state_dict())["adain_stats"]))
    want = dict(_flat(_np(jstate.variables["adain_stats"])))
    assert got.keys() == want.keys() and len(want) == 8
    for k in want:
        assert np.abs(want[k]).max() > 1e-3, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=str(k))


def test_cimle_smoke_train(world):
    """tests/test_depth_trainer.py::test_cimle_smoke_train on the port:
    2 epochs of 3 batches, the loss logged every 3 steps finite and not
    diverging."""
    cfg = _cfg(DepthCfg, base_lr=1e-3, log_interval=3,
               loss_mode="_meanstd-tanh_msgil-normal_")
    logs = []
    state = trainer.train_depth(0, cfg, world["tsampler"], epochs=2,
                                log=lambda m: logs.append(str(m)),
                                device="cpu")
    assert state.step == 6
    losses = [float(line.split("total_loss=")[1].split()[0])
              for line in logs if "total_loss=" in line]
    assert len(losses) >= 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 1.5


def test_resume_roundtrip(world, tmp_path):
    """tests/test_depth_trainer.py::test_resume_roundtrip on the port, in
    its own format (utils.ckpt: model, optimizer, step, epoch)."""
    cfg = _cfg(DepthCfg, num_latent=2, loss_mode="_meanstd-tanh_",
               ckpt_epochs=1)
    saved = {}

    def ckpt_fn(state, epoch):
        path = str(tmp_path / f"resume_e{epoch + 1}")
        save_ckpt(path, dict(model=state.model.state_dict(),
                             opt=state.optimizer, step=state.step,
                             epoch=epoch + 1))
        saved[epoch + 1] = path

    s1 = trainer.train_depth(0, cfg, world["tsampler"], epochs=1,
                             log=lambda *_: None, ckpt_fn=ckpt_fn,
                             device="cpu")
    assert 1 in saved
    restored = load_ckpt(saved[1])
    assert int(restored["epoch"]) == 1 and int(restored["step"]) == 3
    s2 = trainer.train_depth(0, cfg, world["tsampler"], epochs=2,
                             log=lambda *_: None, resume=restored,
                             device="cpu")
    assert s2.step == 2 * s1.step
    assert all(g["count"] == s2.step
               for g in s2.optimizer.param_groups)
