"""Checkpoints, logging and image output of the PyTorch port
(google_nerf_tpu_torch/utils), against the JAX package where the two
meet: the cases of tests/test_logging_utils.py on the port's classes;
full, slim and prefix-filtered checkpoints round-tripped; a JAX
checkpoint carried across (JAX load_ckpt -> convert.train_state_from_jax
-> the port's save_ckpt -> load_ckpt_filtered), every value equal; the
PNG writer read back by imageio, and the turbo depth map.

Tolerances: none; every value must come back bit for bit."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from google_nerf_tpu.data.synthetic import SyntheticDataset as JDataset
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.train import system as jsys
from google_nerf_tpu.utils import ckpt as jckpt
from google_nerf_tpu_torch.convert import train_state_from_jax
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.train import system as tsys
from google_nerf_tpu_torch.utils import ckpt
from google_nerf_tpu_torch.utils import logging as tlog
from google_nerf_tpu_torch.utils.image import TURBO, depth2img, write_png
from google_nerf_tpu_torch.utils.logging import (ScalarLogger, SmoothedValue,
                                                 TrainingStats, debug_mode,
                                                 profile_trace, span)

@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """JSONL only: torch.utils.tensorboard would load TensorFlow into a
    worker that holds jaxlib."""
    monkeypatch.setattr(tlog, "USE_TENSORBOARD", False)


MODEL = dict(scale=0.5, encoder="packed", grid_size=16, packed_levels=2,
             packed_log2_size=8)
TRAIN = dict(batch_size=128, k_samples=16, max_samples=64,
             samples_budget=16 * 128, march="seg")


# ------------------------------------------------ tests/test_logging_utils

def test_smoothed_value_median_and_avg():
    s = SmoothedValue(window_size=3)
    for v in (1.0, 100.0, 2.0, 3.0):
        s.update(v)
    assert s.median == 3.0          # window is [100, 2, 3] -> sorted mid
    assert s.avg == (100 + 2 + 3) / 3
    assert s.global_avg == (1 + 100 + 2 + 3) / 4
    assert s.count == 4


def test_training_stats_eta_and_log(tmp_path):
    logger = ScalarLogger(str(tmp_path))
    st = TrainingStats(total_iters=100, log_interval=10, logger=logger)
    lines = []
    for i in range(1, 21):
        st.iter_tic()
        st.update({"loss": 1.0 / i})
        st.iter_toc()
        st.log_iter_stats(i, print_fn=lines.append)
    assert len(lines) == 2          # iters 10 and 20
    assert "loss=" in lines[0] and "eta" in lines[0]
    assert st.eta_seconds(100) == 0.0
    logger.close()
    recs = [json.loads(line) for line in open(tmp_path / "scalars.jsonl")]
    assert recs[0]["step"] == 10
    assert "loss" in recs[0]


def test_scalar_logger_rank_gated(tmp_path):
    logger = ScalarLogger(str(tmp_path / "r1"), rank=1)
    logger.log(1, {"x": 1.0})
    logger.close()
    assert not os.path.exists(str(tmp_path / "r1"))


def test_profile_trace_annotation_and_debug_mode(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        with span("step_0"):
            torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "step_0" in (tmp_path / "prof" / "trace.json").read_text()
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    debug_mode(nans=True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        debug_mode(nans=False)
    assert not torch.is_anomaly_enabled()


# -------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """A JAX train state (seg layout) after a warmup grid update, saved
    with JAX's save_ckpt, and the port's configs."""
    root = tmp_path_factory.mktemp("jckpt")
    mp = pytest.MonkeyPatch()
    mp.setenv("GNT_GT_CACHE", str(root / "gt"))
    try:
        ds = JDataset(split="train", n_images=3, img_wh=(16, 16))
    finally:
        mp.undo()
    jcfg = jsys.TrainConfig(model=JNGPConfig(**MODEL), **TRAIN)
    cfg = tsys.TrainConfig(model=NGPConfig(**MODEL), **TRAIN)
    st = jsys.init_train_state(jax.random.PRNGKey(0), jcfg, ds.K, ds.poses,
                               ds.img_wh)
    st = jsys.grid_update_step(st, jax.random.PRNGKey(1), cfg=jcfg,
                               warmup=True)
    path = str(root / "epoch=0")
    jckpt.save_ckpt(path, st)
    return ds, jcfg, cfg, path


def _port_state(ds, cfg, seed=0):
    return tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                                 generator=torch.Generator().manual_seed(
                                     seed), device="cpu")


def _leaves(state):
    return {k: v for k, v in ckpt._flatten_paths(
        {k: v for k, v in state.items() if k != "opt"}).items()}


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(torch.as_tensor(la[k]).detach(),
                                      torch.as_tensor(lb[k]).detach(),
                                      err_msg=k)


def test_full_ckpt_round_trip_resumes_the_optimizer(jax_world, tmp_path):
    """A full checkpoint after two Adam steps loads into a fresh state:
    every tensor, the step and the optimizer's moments come back, and
    the params stay the ones the loaded optimizer updates."""
    ds, _, cfg, _ = jax_world
    st = _port_state(ds, cfg)
    scene = {k: torch.tensor(v) for k, v in
             dict(images=ds.rays, alphas=ds.alphas, poses=ds.poses,
                  directions=ds.directions).items()}
    gen = torch.Generator().manual_seed(3)
    tsys.grid_update_step(st, cfg, warmup=True, generator=gen)
    for _ in range(2):
        tsys.fused_train_step(st, scene, cfg, generator=gen)
    ckpt.save_ckpt(str(tmp_path / "full"), st)
    back = ckpt.load_ckpt(str(tmp_path / "full"),
                          target=_port_state(ds, cfg, seed=1))
    _assert_equal(back, st)
    assert back["step"] == 2
    so, bo = st["opt"].state_dict(), back["opt"].state_dict()
    assert sorted(so["state"]) == sorted(bo["state"])
    for i, s in so["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(bo["state"][i][k])), (i, k)
    opt_params = [p for g in back["opt"].param_groups for p in g["params"]]
    assert all(any(p is q for q in opt_params)
               for p in tsys.param_leaves(back["params"]).values())
    raw = ckpt.load_ckpt(str(tmp_path / "full"))
    assert sorted(raw) == sorted(st)


def test_slim_ckpt_and_filtered_load(jax_world, tmp_path):
    """The slim checkpoint holds params (no dR/dT unless save_poses), occ
    and step; loaded with test.py's prefixes into a fresh state it
    restores those, keeps the target's density grid and occ_u8, and keeps
    the target's value of a leaf whose shape differs."""
    ds, _, cfg, _ = jax_world
    st = _port_state(ds, cfg)
    st["params"]["dR"] = torch.ones((3, 3))
    st["params"]["dT"] = torch.ones((3, 3))
    st["occ"] = torch.rand(st["occ"].shape,
                           generator=torch.Generator().manual_seed(0)) > 0.5
    st["step"] = 7
    ckpt.save_slim_ckpt(str(tmp_path / "slim"), st)
    ckpt.save_slim_ckpt(str(tmp_path / "slim_poses"), st, save_poses=True)
    raw = ckpt.load_ckpt(str(tmp_path / "slim"))
    assert sorted(raw) == ["occ", "params", "step"]
    assert "dR" not in raw["params"]
    assert "dR" in ckpt.load_ckpt(str(tmp_path / "slim_poses"))["params"]
    tgt = _port_state(ds, cfg, seed=1)
    grid0 = tgt["density_grid"].clone()
    tgt["density_grid"] += 1.0
    grid1 = tgt["density_grid"].clone()
    got = ckpt.load_ckpt_filtered(
        str(tmp_path / "slim"), tgt,
        include_prefixes=("params", "occ", "step", "density_grid"))
    assert got is tgt and got["step"] == 7
    assert torch.equal(got["occ"], st["occ"])
    assert torch.equal(got["density_grid"], grid1)
    assert not torch.equal(got["density_grid"], grid0)
    for k, v in tsys.param_leaves(st["params"]).items():
        if k not in ("dR", "dT"):
            assert torch.equal(tsys.param_leaves(got["params"])[k], v), k
    # a shape mismatch keeps the target's value; excluded prefixes too
    small = dict(params=dict(packed_table=torch.zeros(1, 2, 3),
                             rgb_mlp=[torch.full_like(w, 5.0)
                                      for w in st["params"]["rgb_mlp"]]))
    ckpt.save_ckpt(str(tmp_path / "odd"), small)
    tgt2 = _port_state(ds, cfg, seed=1)
    table0 = tgt2["params"]["packed_table"].clone()
    rgb0 = [w.clone() for w in tgt2["params"]["rgb_mlp"]]
    ckpt.load_ckpt_filtered(str(tmp_path / "odd"), tgt2,
                            exclude_prefixes=("params/rgb_mlp/1",))
    assert torch.equal(tgt2["params"]["packed_table"], table0)
    assert torch.equal(tgt2["params"]["rgb_mlp"][0],
                       small["params"]["rgb_mlp"][0])
    assert torch.equal(tgt2["params"]["rgb_mlp"][1], rgb0[1])
    with pytest.raises(FileNotFoundError):
        ckpt.load_ckpt_filtered(str(tmp_path / "missing"), tgt2)


def test_jax_ckpt_crosses_through_convert(jax_world, tmp_path):
    """JAX's checkpoint -> JAX load_ckpt -> train_state_from_jax -> the
    port's save_ckpt -> load_ckpt_filtered into a fresh port state: every
    param, the density grid, occ, the seg word grid and the step equal
    JAX's values."""
    ds, _, cfg, path = jax_world
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_ckpt(path))
    st = train_state_from_jax({k: tree[k] for k in (
        "params", "density_grid", "occ", "occ_u8", "step")}, cfg, "cpu")
    ckpt.save_ckpt(str(tmp_path / "ported"), st)
    got = ckpt.load_ckpt_filtered(
        str(tmp_path / "ported"), _port_state(ds, cfg, seed=5),
        include_prefixes=("params", "occ", "step", "density_grid"))
    jl = jckpt._flatten_paths({k: tree[k] for k in (
        "params", "density_grid", "occ", "occ_u8")})
    pl = _leaves(got)
    assert sorted(jl) == sorted(k for k in pl if k != "step")
    for k, v in jl.items():
        np.testing.assert_array_equal(pl[k].detach().numpy(), v, err_msg=k)
    assert got["step"] == int(tree["step"])
    assert pl["occ_u8"].dtype == torch.int32 and pl["occ_u8"].ndim == 4


def test_pytree_npz_round_trip(tmp_path):
    tree = dict(a=torch.arange(6.0).reshape(2, 3),
                b=dict(c=np.int32(3), d=torch.ones(2, dtype=torch.int64)))
    ckpt.save_pytree(str(tmp_path / "t.npz"), tree)
    back = ckpt.load_pytree(str(tmp_path / "t.npz"))
    assert torch.equal(back["a"], tree["a"])
    assert int(back["b"]["c"]) == 3
    assert torch.equal(back["b"]["d"], tree["b"]["d"])
    jback = jckpt.load_pytree(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(jback["a"], tree["a"].numpy())


# --------------------------------------------------------------- images

def test_png_writer_reads_back_and_depth_is_turbo(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.RandomState(0)
    img = (rng.rand(7, 5, 3) * 255).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "a.png")),
                                  img)
    depth = rng.rand(4, 6).astype(np.float32)
    d8 = depth2img(depth)
    assert d8.shape == (4, 6, 3) and d8.dtype == np.uint8
    lo, hi = np.unravel_index(depth.argmin(), depth.shape), \
        np.unravel_index(depth.argmax(), depth.shape)
    np.testing.assert_array_equal(d8[lo], TURBO[0])
    np.testing.assert_array_equal(d8[hi], TURBO[255])
    assert TURBO.shape == (256, 3)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img[..., :2])
