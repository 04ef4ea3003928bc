"""The port's CLIs on datasets on disk, on the CPU, with
tests/test_cli_e2e.py's TINY flags and its fixtures (tests/test_loaders.py
and tests/test_data.py write them):

  * train_torch.py end to end on the nsvf fixture and on the colmap one
    at --scale 4.0 (4 cascades, exp_step_factor 1/256, the grid eroded,
    render_test in validation), and train_scannet_torch.py on the
    ScanNet fixture with depth priors (--depth_dir, --depth_loss_w 0.1):
    checkpoints written, the validation PSNR finite; the Synthetic NSVF
    run prints train.py's video warning;
  * train_debug_torch.py: its steps, the state's leaves, the grid
    update's occupancy and the table's statistics;
  * slice parity: JAX's train.py (nsvf; colmap at scale 4) and
    train_scannet.py (depth-supervised) train a checkpoint; JAX's test.py
    and the port's test_torch.py serve it (the state carried across by
    convert.train_state_from_jax) with the one-shot and the fast
    renderer: mean PSNR within 0.05 dB, as tests/test_torch_cli_parity.py
    holds the synthetic scene.
"""
import glob
import os

import jax
import numpy as np
import pytest

import test as jax_test
import test_torch
import train_debug_torch
import train_scannet as jax_train_scannet
import train_scannet_torch
import train_torch
from google_nerf_tpu.utils.ckpt import load_ckpt
from google_nerf_tpu_torch.convert import train_state_from_jax
from google_nerf_tpu_torch.opt import get_opts
from google_nerf_tpu_torch.utils import logging as tlog
from google_nerf_tpu_torch.utils.ckpt import save_ckpt
from opt import get_opts as jax_get_opts
from test_data import _write_scannet_fixture
from test_loaders import _make_colmap_scene, _make_nsvf_scene
from test_torch_cli_parity import one_torch_thread  # noqa: F401
from train import main as jax_train_main

TINY = [
    "--num_epochs", "1", "--steps_per_epoch", "20", "--batch_size", "128",
    "--grid_size", "16", "--packed_levels", "2", "--packed_log2_size", "8",
    "--max_samples", "64", "--k_samples", "16", "--platform", "cpu",
]


def _scannet(root):
    """tests/test_data.py's ScanNet fixture (640x480 JPEG frames, test
    step 8) with .npy depth priors in metres."""
    scene = _write_scannet_fixture(root)
    depth_dir = os.path.join(root, "priors")
    os.makedirs(depth_dir)
    rng = np.random.RandomState(1)
    for i in range(3):
        np.save(os.path.join(depth_dir, f"{i}.npy"),
                rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32))
    return scene, depth_dir


def scene_args(name, root):
    if name == "nsvf":
        return ["--root_dir", _make_nsvf_scene(root), "--dataset_name",
                "nsvf", "--downsample", "0.01"]
    if name == "colmap":
        return ["--root_dir", _make_colmap_scene(os.path.join(root, "s")),
                "--dataset_name", "colmap", "--scale", "4.0"]
    scene, depth_dir = _scannet(root)
    return ["--root_dir", scene, "--dataset_name", "scannet",
            "--downsample", "0.1", "--test_skip", "8", "--raw_scan_rootdir",
            root, "--depth_dir", depth_dir, "--depth_loss_w", "0.1"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # JSONL only: torch.utils.tensorboard would load TensorFlow into a
    # worker that holds jaxlib
    monkeypatch.setattr(tlog, "USE_TENSORBOARD", False)


@pytest.mark.parametrize("name", ["nsvf", "colmap", "scannet"])
def test_train_cli_on_a_dataset_e2e(tmp_path, monkeypatch, capsys, name):
    argv = scene_args(name, str(tmp_path)) + TINY + ["--exp_name", "e2e"]
    monkeypatch.chdir(tmp_path)
    if name == "scannet":
        logs = train_scannet_torch.run(argv)
    else:
        logs = train_torch.main(get_opts(argv))
    assert np.isfinite(logs["psnr"])
    ckpts = glob.glob(str(tmp_path / "ckpts" / name / "e2e" / "epoch=0*"))
    assert sorted(os.path.basename(c) for c in ckpts) == ["epoch=0",
                                                          "epoch=0_slim"]
    res = tmp_path / "results" / name / "e2e"
    assert len(list(res.glob("*_d.png"))) > 0
    out = capsys.readouterr().out
    assert ("[warn] video export skipped" in out) == (name != "colmap")


def test_train_debug_cli(tmp_path, monkeypatch, capsys):
    argv = scene_args("scannet", str(tmp_path)) + TINY
    monkeypatch.chdir(tmp_path)
    state, metrics = train_debug_torch.main(get_opts(argv), steps=3)
    out = capsys.readouterr().out
    assert state["step"] == 3 and np.isfinite(float(metrics["loss"]))
    for needle in ("state leaves:", "params/packed_table", "density_grid",
                   "[step 0] grid update: occ_frac=", "[step 2] loss=",
                   "table stats: mean|w|="):
        assert needle in out, needle


PARITY = ["nsvf", "colmap", "scannet"]


@pytest.fixture(scope="module", params=PARITY)
def carried(request, tmp_path_factory):
    """JAX's CLI trains a checkpoint of the dataset; the port's copy of
    the same state next to it."""
    name = request.param
    root = tmp_path_factory.mktemp(f"parity_{name}")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    try:
        argv = scene_args(name, str(root)) + TINY + [
            "--exp_name", "parity", "--no_save_test"]
        if name == "scannet":
            jax_train_scannet.run(argv)
        else:
            jax_train_main(jax_get_opts(argv), video_fps=1)
        jpath = str(root / "ckpts" / name / "parity" / "epoch=0")
        tree = jax.tree_util.tree_map(np.asarray, load_ckpt(jpath))
        st = train_state_from_jax({k: tree[k] for k in (
            "params", "density_grid", "occ", "occ_u8", "step")},
            train_torch.build_configs(get_opts(argv)), "cpu")
        tpath = str(root / "port_epoch=0")
        save_ckpt(tpath, st)
    finally:
        mp.undo()
    return root, argv, jpath, tpath


@pytest.mark.parametrize("renderer", ["oneshot", "fast"])
def test_cli_psnr_matches_jax_on_the_dataset(carried, monkeypatch,
                                             renderer):
    root, argv, jpath, tpath = carried
    monkeypatch.chdir(root)
    r = ["--renderer", renderer]
    want = jax_test.run(jax_get_opts(argv + r + ["--ckpt_path", jpath]))
    got = test_torch.run(get_opts(argv + r + ["--ckpt_path", tpath]))
    assert np.isfinite(want["psnr"])
    assert abs(got["psnr"] - want["psnr"]) <= 0.05, (got["psnr"],
                                                     want["psnr"])
