"""Slice parity of the CLIs: JAX's train.py trains a checkpoint (the
TINY flags of tests/test_cli_e2e.py on the synthetic scene at 16x16);
JAX's test.py serves it, and the port's test_torch.py serves the same
state carried across (JAX load_ckpt -> convert.train_state_from_jax ->
the port's save_ckpt).  Each renderer's mean PSNR over the 50 test views
agrees with JAX's within 0.05 dB.  This file: the one-shot renderer
(test.py's default) and the fast renderer on the packed encoder, and the
one-shot renderer on a checkpoint of the hash grid (`--xyz_encoder hash`,
4 levels of 2^10 rows);
tests/test_torch_cli_parity_bake.py: the baked renderers."""
import os

import jax
import numpy as np
import pytest
import torch

import test as jax_test
import test_torch
import train as jax_train
from google_nerf_tpu.utils.ckpt import load_ckpt
from google_nerf_tpu_torch.convert import train_state_from_jax
from google_nerf_tpu_torch.opt import get_opts
from google_nerf_tpu_torch.utils.ckpt import save_ckpt
from opt import get_opts as jax_get_opts
from train_torch import build_configs

TINY = [
    "--num_epochs", "1", "--steps_per_epoch", "20", "--batch_size", "128",
    "--grid_size", "16", "--packed_levels", "2", "--packed_log2_size", "8",
    "--max_samples", "64", "--k_samples", "16", "--no_save_test",
    "--platform", "cpu", "--root_dir", "x", "--dataset_name", "synthetic",
    "--downsample", "0.25", "--exp_name", "parity",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CLIs' frames are tiny: one intra-op thread is faster than
    eight, and does not fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HASH = ["--xyz_encoder", "hash", "--num_levels", "4",
        "--log2_hashmap_size", "10"]


def train_and_carry(root, flags=()):
    """JAX's train.py in root -> (JAX's full checkpoint, the port's copy
    of the same state)."""
    argv = TINY + list(flags)
    jax_train.main(jax_get_opts(argv), video_fps=1)
    jpath = os.path.abspath("ckpts/synthetic/parity/epoch=0")
    tree = jax.tree_util.tree_map(np.asarray, load_ckpt(jpath))
    st = train_state_from_jax({k: tree[k] for k in (
        "params", "density_grid", "occ", "occ_u8", "step")},
        build_configs(get_opts(argv)), "cpu")
    tpath = str(root / "port_epoch=0")
    save_ckpt(tpath, st)
    return jpath, tpath


def carried_world(tmp_path_factory, flags=()):
    root = tmp_path_factory.mktemp("parity")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    mp.setenv("GNT_GT_CACHE", str(root / "gt_jax"))
    mp.setenv("GNT_TORCH_GT_CACHE", str(root / "gt_torch"))
    try:
        jpath, tpath = train_and_carry(root, flags)
    finally:
        mp.undo()
    return root, jpath, tpath


def serve_both(world, monkeypatch, renderer, flags=()):
    """Mean PSNR of JAX's test.run and of the port's test_torch.run."""
    root, jpath, tpath = world
    monkeypatch.chdir(root)
    monkeypatch.setenv("GNT_GT_CACHE", str(root / "gt_jax"))
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(root / "gt_torch"))
    argv = TINY + list(flags) + renderer
    want = jax_test.run(jax_get_opts(argv + ["--ckpt_path", jpath]))
    got = test_torch.run(get_opts(argv + ["--ckpt_path", tpath]))
    return got["psnr"], want["psnr"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return carried_world(tmp_path_factory)


@pytest.mark.parametrize("renderer", [["--renderer", "oneshot"],
                                      ["--renderer", "fast"]],
                         ids=["oneshot", "fast"])
def test_cli_psnr_matches_jax(world, monkeypatch, renderer):
    got, want = serve_both(world, monkeypatch, renderer)
    assert np.isfinite(want)
    assert abs(got - want) <= 0.05, (got, want)


@pytest.fixture(scope="module")
def hash_world(tmp_path_factory):
    return carried_world(tmp_path_factory, HASH)


def test_cli_psnr_matches_jax_hash(hash_world, monkeypatch):
    """The hash grid: JAX's train.py checkpoint carried across (its
    hash_table) and served by both CLIs' one-shot renderer."""
    got, want = serve_both(hash_world, monkeypatch, ["--renderer",
                                                     "oneshot"], HASH)
    assert np.isfinite(want)
    assert abs(got - want) <= 0.05, (got, want)
