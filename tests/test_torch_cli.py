"""The PyTorch port's CLIs end to end on the CPU (train_torch.py ->
checkpoints -> validation; test_torch.py on the checkpoint), with
tests/test_cli_e2e.py's TINY flags on the synthetic scene at 16x16.

Checks: the full and slim checkpoints exist and the validation PSNR is
finite; --val_only on the full checkpoint gives the training run's
validation logs exactly (one state, one deterministic renderer);
test_torch.run serves the slim checkpoint; the PNGs and the JSONL
scalars land where train.py puts them; every other --xyz_encoder (hash,
freq, packed2) and --march block train, checkpoint (the encoder's param
keys round-trip) and serve; the CLIs refuse what the port does not run
(no card without --platform cpu, several cards) and what JAX's loaders
refuse (an NSVF root without bbox.txt), and an RTMV scene whose OpenEXR
frame is corrupt raises with the frame's path."""
import glob
import json

import numpy as np
import pytest
import torch

import test_torch
import train_torch
from google_nerf_tpu_torch.opt import get_opts
from google_nerf_tpu_torch.utils import logging as tlog
from test_torch_cli_parity import one_torch_thread  # noqa: F401

TINY = [
    "--num_epochs", "1", "--steps_per_epoch", "20", "--batch_size", "128",
    "--grid_size", "16", "--packed_levels", "2", "--packed_log2_size", "8",
    "--max_samples", "64", "--k_samples", "16",
]
SYN = ["--root_dir", "x", "--dataset_name", "synthetic", "--downsample",
       "0.25"]
CPU = TINY + SYN + ["--platform", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One TINY training run in its own directory, PNGs and logs on."""
    root = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    mp.setenv("GNT_TORCH_GT_CACHE", str(root / "gt"))
    # JSONL only: torch.utils.tensorboard would load TensorFlow into a
    # worker that holds jaxlib
    mp.setattr(tlog, "USE_TENSORBOARD", False)
    try:
        logs = train_torch.main(get_opts(CPU + ["--exp_name", "tiny"]))
    finally:
        mp.undo()
    return root, logs


def test_train_writes_checkpoints_pngs_and_logs(trained):
    root, logs = trained
    assert np.isfinite(logs["psnr"]) and np.isfinite(logs["ssim"])
    assert logs["train_time_net_s"] >= 0     # 20 steps: no rate yet
    ckpts = glob.glob(str(root / "ckpts" / "synthetic" / "tiny" / "epoch=0*"))
    assert sorted(c.rsplit("/", 1)[1] for c in ckpts) == ["epoch=0",
                                                          "epoch=0_slim"]
    res = root / "results" / "synthetic" / "tiny"
    assert len(list(res.glob("[0-9][0-9][0-9].png"))) == 50
    assert len(list(res.glob("*_d.png"))) == 50
    recs = [json.loads(line) for line in open(res / "logs" / "scalars.jsonl")]
    assert recs[-1]["step"] == 20
    assert recs[-1]["test/psnr"] == pytest.approx(logs["psnr"])


def test_val_only_gives_the_training_logs(trained, monkeypatch):
    root, logs = trained
    monkeypatch.chdir(root)
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(root / "gt"))
    val = train_torch.main(get_opts(
        CPU + ["--exp_name", "val", "--no_save_test", "--val_only",
               "--ckpt_path", str(root / "ckpts/synthetic/tiny/epoch=0")]))
    assert val == {k: logs[k] for k in ("psnr", "ssim")}


@pytest.mark.parametrize("renderer", [["--renderer", "fast"],
                                      ["--renderer", "fast", "--bake",
                                       "--bake_res", "32"]])
def test_test_cli_serves_the_slim_checkpoint(trained, monkeypatch,
                                             renderer):
    root, logs = trained
    monkeypatch.chdir(root)
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(root / "gt"))
    out = test_torch.run(get_opts(
        CPU + renderer + ["--ckpt_path",
                          str(root / "ckpts/synthetic/tiny/epoch=0_slim")]))
    assert np.isfinite(out["psnr"]) and out["fps"] > 0
    if "--bake" not in renderer:
        # validate renders through the same renderer at T_threshold 1e-2
        assert out["psnr"] == pytest.approx(logs["psnr"], abs=1e-4)


@pytest.mark.parametrize("flags,table", [
    (["--xyz_encoder", "hash", "--num_levels", "4", "--log2_hashmap_size",
      "10"], "hash_table"),
    (["--xyz_encoder", "freq"], None),
    (["--xyz_encoder", "packed2"], "pair_table"),
    (["--march", "block"], "packed_table"),
], ids=["hash", "freq", "packed2", "block"])
def test_every_encoder_and_march_trains_and_serves(monkeypatch, tmp_path,
                                                   flags, table):
    """train_torch.py then test_torch.py (oneshot; with --march block its
    block rows) for each encoder and the block marcher: finite PSNR, the
    slim checkpoint holds the encoder's params, and --val_only on the
    full checkpoint gives the run's logs."""
    from google_nerf_tpu_torch.utils.ckpt import load_ckpt
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(tmp_path / "gt"))
    monkeypatch.setattr(tlog, "USE_TENSORBOARD", False)
    argv = CPU + flags + ["--exp_name", "enc", "--no_save_test"]
    logs = train_torch.main(get_opts(argv))
    assert np.isfinite(logs["psnr"])
    ck = tmp_path / "ckpts/synthetic/enc/epoch=0"
    params = load_ckpt(str(ck) + "_slim")["params"]
    assert sorted(params) == sorted(k for k in (table, "rgb_mlp",
                                                "sigma_mlp") if k)
    val = train_torch.main(get_opts(argv + ["--val_only", "--ckpt_path",
                                            str(ck)]))
    assert val == {k: logs[k] for k in ("psnr", "ssim")}
    out = test_torch.run(get_opts(argv + ["--renderer", "oneshot",
                                          "--ckpt_path", str(ck) + "_slim"]))
    assert np.isfinite(out["psnr"]) and out["fps"] > 0


def test_clis_refuse_what_the_port_does_not_run(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        train_torch.main(get_opts(TINY + SYN))
    with pytest.raises(RuntimeError, match="--platform cpu"):
        test_torch.run(get_opts(TINY + SYN + ["--ckpt_path", "x"]))
    nsvf = tmp_path / "Synthetic_NeRF" / "Lego"       # no bbox.txt
    (nsvf / "rgb").mkdir(parents=True)
    with pytest.raises(OSError, match="bbox.txt"):
        train_torch.main(get_opts(TINY + ["--root_dir", str(nsvf),
                                          "--dataset_name", "nsvf",
                                          "--platform", "cpu"]))
    rtmv = tmp_path / "rtmv_scene"
    (rtmv / "images").mkdir(parents=True)
    (rtmv / "images" / "00000.exr").write_bytes(b"\x76\x2f\x31\x01" + bytes(60))
    (rtmv / "00000.json").write_text(json.dumps({"camera_data": {
        "cam2world": np.eye(4).tolist(), "width": 8, "height": 8,
        "intrinsics": {"fx": 10.0, "fy": 10.0, "cx": 4.0, "cy": 4.0},
        "scene_center_3d_box": [0, 0, 0], "scene_min_3d_box": [-1, -1, -1],
        "scene_max_3d_box": [1, 1, 1]}}))
    with pytest.raises(ValueError, match="00000.exr: .*OpenEXR"):
        train_torch.main(get_opts(TINY + ["--root_dir", str(rtmv),
                                          "--dataset_name", "rtmv",
                                          "--platform", "cpu"]))
    with pytest.raises(RuntimeError, match="torchrun"):
        train_torch.main(get_opts(CPU + ["--num_gpus", "2"]))
    with pytest.raises(RuntimeError, match="torchrun"):
        test_torch.run(get_opts(CPU + ["--num_gpus", "2", "--ckpt_path",
                                       "x"]))
    with pytest.raises(ValueError, match="ckpt_path"):
        train_torch.main(get_opts(CPU + ["--val_only"]))
