"""The port's CLIs at --num_gpus 2 as a world of two gloo ranks on the
CPU (--platform cpu), as torchrun would start them: train_torch.main
(tests/test_torch_cli.py's TINY flags, data-parallel steps, the grid
update on every rank, validation through render_test_fast_dp), then
test_torch.run on its slim checkpoint with the one-shot renderer
(render_test_oneshot_dp) and the brick renderer over a 32^3 bake
(render_brick_dp, the auto pairs budget).

Checks: both ranks end with the same params and the same validation
logs; rank 0 alone writes (one JSONL record of the final validation, one
PNG pair a test view, the checkpoints); each --num_gpus 2 serve's mean
PSNR equals --num_gpus 1 on the same checkpoint within 1e-5 dB, and its
frame-0 telemetry (the brick's summed over the ranks) is equal; the
validation PSNR of the DP run is finite.  --num_gpus 2 outside a world of
two raises, naming torchrun (tests/test_torch_cli.py)."""
import json

import numpy as np
import pytest

import test_torch
from google_nerf_tpu_torch.opt import get_opts
from google_nerf_tpu_torch.parallel.launch import run_world
from google_nerf_tpu_torch.utils import logging as tlog
from test_torch_cli import CPU
from test_torch_cli_parity import one_torch_thread  # noqa: F401
from test_torch_dp_ranks import cli_cases

N = 2
TRAIN = CPU + ["--num_gpus", str(N), "--exp_name", "dp"]
SERVE = [CPU + ["--ckpt_path", "ckpts/synthetic/dp/epoch=0_slim",
                "--exp_name", "dp"] + r
         for r in (["--renderer", "oneshot"],
                   ["--renderer", "brick", "--bake_res", "32"])]


@pytest.fixture(scope="module")
def dp_cli(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_dp")
    ranks = run_world(cli_cases, N, (str(root), TRAIN,
                                     [a + ["--num_gpus", str(N)]
                                      for a in SERVE]), timeout=120)
    return root, ranks


def test_ranks_end_equal(dp_cli):
    _, (r0, r1) = dp_cli
    assert sorted(r0["params"]) == ["packed_table"]
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(v, r1["params"][k], err_msg=k)
    assert r0["logs"] == r1["logs"]
    assert np.isfinite(r0["logs"]["psnr"])


def test_rank_zero_alone_writes(dp_cli):
    root, _ = dp_cli
    ck = root / "ckpts" / "synthetic" / "dp"
    assert (ck / "epoch=0").exists() and (ck / "epoch=0_slim").exists()
    res = root / "results" / "synthetic" / "dp"
    pngs = sorted(p.name for p in res.glob("*.png"))
    n_views = len([p for p in pngs if not p.endswith("_d.png")])
    assert n_views > 0 and len(pngs) == 2 * n_views
    lines = (res / "logs" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 1 and "test/psnr" in json.loads(lines[0])


@pytest.mark.parametrize("i", range(len(SERVE)), ids=["oneshot", "brick"])
def test_dp_serve_equals_one_device(dp_cli, monkeypatch, i):
    root, ranks = dp_cli
    monkeypatch.chdir(root)
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(root / "gt"))
    monkeypatch.setattr(tlog, "USE_TENSORBOARD", False)
    want = test_torch.run(get_opts(SERVE[i]))
    for r in ranks:
        got = r["served"][i]
        assert abs(got["psnr"] - want["psnr"]) <= 1e-5, (got, want)
        if i == 1:
            assert got["frame0"] == want["frame0"]
