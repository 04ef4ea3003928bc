"""train/system.fused_train_steps of the port (n fused steps on a list of
per-step draws) against the serial loop of fused_train_step and against
JAX's fused_train_steps (one lax.scan over the steps; step i on the key
fold_in(key, i)), on tests/test_train_scan.py's setup: 4 packed levels
of 2^10 rows, grid 32, batch 256, random backgrounds, backfill, 4 views
at 24^2, JAX's state after a warmup grid update carried across.

The port's steps equal the serial loop bit for bit (the same calls on
the same draws); its last loss lies within test_train_scan.py's 1e-4 of
JAX's, and the step count is n.  apply_grads from loss_and_grads'
gradients is train_step, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from google_nerf_tpu.data.synthetic import SyntheticDataset
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.train import system as jsys
from google_nerf_tpu_torch.convert import train_state_from_jax
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.train import system as tsys
from test_torch_train_step import jax_step_draws

MODEL = dict(scale=0.5, encoder="packed", packed_levels=4,
             packed_log2_size=10, grid_size=32)
TRAIN = dict(batch_size=256, k_samples=16, max_samples=64, random_bg=True,
             exclude_incomplete="backfill")
N_STEPS = 4
KEY = jax.random.PRNGKey(3)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = jsys.TrainConfig(model=JNGPConfig(**MODEL), **TRAIN)
    cfg = tsys.TrainConfig(model=NGPConfig(**MODEL), **TRAIN)
    ds = SyntheticDataset(split="train", n_images=4, img_wh=(24, 24))
    state = jsys.init_train_state(jax.random.PRNGKey(0), jcfg, ds.K,
                                  ds.poses, ds.img_wh)
    state = jsys.grid_update_step(state, jax.random.PRNGKey(1), cfg=jcfg,
                                  warmup=True)
    tree = np_tree({k: state[k] for k in ("params", "density_grid", "occ",
                                          "occ_u8", "step")})
    scene = ds.scene()
    np_scene = np_tree(scene)
    draws = [jax_step_draws(jax.random.fold_in(KEY, i), np_scene,
                            cfg.batch_size)[1] for i in range(N_STEPS)]
    _, jm = jsys.fused_train_steps(state, scene, KEY, cfg=jcfg,
                                   n_steps=N_STEPS)
    return dict(cfg=cfg, tree=tree, draws=draws, jloss=float(jm["loss"]),
                scene={k: torch.as_tensor(v) for k, v in np_scene.items()})


def test_scan_matches_serial_loop(setup):
    cfg, sc, draws = setup["cfg"], setup["scene"], setup["draws"]
    serial = train_state_from_jax(setup["tree"], cfg, "cpu")
    for d in draws:
        serial, m_serial = tsys.fused_train_step(serial, sc, cfg, draws=d)
    fused, m_fused = tsys.fused_train_steps(
        train_state_from_jax(setup["tree"], cfg, "cpu"), sc, cfg,
        n_steps=N_STEPS, draws=draws)
    assert fused["step"] == serial["step"] == N_STEPS
    for k, v in tsys.param_leaves(fused["params"]).items():
        np.testing.assert_array_equal(
            v.detach().numpy(),
            tsys.param_leaves(serial["params"])[k].detach().numpy(),
            err_msg=k)
    for k in m_serial:
        assert float(m_fused[k]) == float(m_serial[k]), k
    assert abs(float(m_fused["loss"]) - setup["jloss"]) < 1e-4
    with pytest.raises(ValueError, match="3 draws for 4 steps"):
        tsys.fused_train_steps(fused, sc, cfg, n_steps=N_STEPS,
                               draws=draws[:3])


def test_apply_grads_is_the_train_step(setup):
    """loss_and_grads then apply_grads (the data-parallel step's path, at
    a world of one) leaves the params train_step leaves, bit for bit."""
    cfg, sc, d = setup["cfg"], setup["scene"], setup["draws"][0]
    a = train_state_from_jax(setup["tree"], cfg, "cpu")
    b = train_state_from_jax(setup["tree"], cfg, "cpu")
    batch = tsys.sample_batch(sc, cfg.batch_size, img_idxs=d["img_idxs"],
                              pix_idxs=d["pix_idxs"])
    tsys.train_step(a, sc, batch, cfg, draws=d)
    _, _, grads = tsys.loss_and_grads(b, sc, batch, cfg, draws=d)
    lr = tsys.apply_grads(b, grads, cfg)
    assert lr == tsys.cosine_lr(cfg)(0)
    for k, v in tsys.param_leaves(a["params"]).items():
        np.testing.assert_array_equal(
            v.detach().numpy(),
            tsys.param_leaves(b["params"])[k].detach().numpy(), err_msg=k)
        assert v.grad is None
