"""The port's depth training and evaluation CLIs against JAX's on the
CPU, on annotation datasets the tests write:

  * depth_train_torch.py --platform cpu at resnet18, crop 64, d_latent
    8, 2 epochs: the epoch and final .npz in JAX's save_pytree layout,
    which JAX's load_pytree reads and JAX's depth_forward runs equal to
    the port's forward on the same file (norm-relative 1e-5: f32
    convolutions summed in another order); --resume from resume_epoch1
    continues to the step count of both epochs;
  * depth_eval_torch.py against depth_eval.py on one checkpoint in
    JAX's save_pytree layout (resnet18, d_latent 8, three hypotheses),
    for --select first, loss
    and best_metric, JAX's latents through the `latents` hook: the
    metric battery within 1e-4 of JAX's printed (4-decimal) values plus
    their rounding;
  * both CLIs refuse to run without a card unless given --platform cpu."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depth_eval as jax_depth_eval
import depth_eval_torch
import depth_train_torch
from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import depth_forward as jax_forward
from google_nerf_tpu.utils.ckpt import load_pytree, save_pytree
from google_nerf_tpu_torch.convert import depth_state_to_jax
from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                               depth_forward,
                                               init_depth_model)
from google_nerf_tpu_torch.depth.weights import load_checkpoint
from test_torch_depth_data import write_dataset

CROP = 64
LATENT = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these networks are small, and the test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("depth_train_cli"))
    write_dataset(root, "demo", n=4, hw=(72, 80))
    write_dataset(root, "evalset", n=2, hw=(60, 70), seed=3, split="test")
    return root


def _train_argv(root, out, epochs, *extra):
    return ["--dataroot", root, "--dataset_list", "demo", "--backbone",
            "resnet18", "--crop_size", str(CROP), "--d_latent", str(LATENT),
            "--epoch", str(epochs), "--out_dir", out, "--platform", "cpu",
            "--options", "TRAIN.CKPT_EPOCHS", "1", "TRAIN.NUM_LATENT", "4",
            "TRAIN.LATENT_MINIBATCH", "2", *extra]


def test_train_cli_writes_jax_checkpoints_and_resumes(root, tmp_path):
    out = str(tmp_path / "run")
    run = depth_train_torch.main(_train_argv(root, out, 2))
    steps = [h for h in run["history"] if h["kind"] == "step"]
    assert run["state"].step == len(steps) == 4      # 2 epochs x 2 batches
    assert all(np.isfinite(h["total_loss"]) for h in steps)
    for name in ("epoch1.npz", "epoch2.npz", "final.npz", "resume_epoch1",
                 "resume_epoch2"):
        assert os.path.exists(os.path.join(out, name)), name

    # JAX's loader and forward on the port's final.npz
    variables = load_pytree(os.path.join(out, "final.npz"))
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(1, CROP, CROP, 3)).astype(np.float32)
    z = rng.normal(size=(1, LATENT)).astype(np.float32)
    want = np.asarray(jax_forward(variables, JConfig(
        backbone="resnet18", d_latent=LATENT), jnp.asarray(rgb),
        z=jnp.asarray(z)))
    model = init_depth_model(torch.Generator().manual_seed(1),
                             DepthModelConfig(backbone="resnet18",
                                              d_latent=LATENT), "cpu")
    load_checkpoint(model, os.path.join(out, "final.npz"))
    sd = run["state"].model.state_dict()
    for k, v in model.state_dict().items():    # the npz has no counts
        assert k.endswith("num_batches_tracked") or torch.equal(
            v, sd[k].cpu()), k
    got = depth_forward(model, torch.from_numpy(rgb).permute(0, 3, 1, 2),
                        torch.from_numpy(z)).numpy().transpose(0, 2, 3, 1)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5

    # --resume from epoch 1 runs epoch 2 only
    out2 = str(tmp_path / "resumed")
    again = depth_train_torch.main(_train_argv(
        root, out2, 2, "--resume", os.path.join(out, "resume_epoch1")))
    assert again["state"].step == 4
    assert [h["epoch"] for h in again["history"]
            if h["kind"] == "step"] == [1, 1]
    assert all(g["count"] == 4
               for g in again["state"].optimizer.param_groups)


def _metrics(out):
    line = [ln for ln in out.splitlines() if ln.startswith("metrics:")]
    assert len(line) == 1, out
    return eval(line[0][len("metrics:"):], {})


@pytest.fixture(scope="module")
def jax_ckpt(root):
    """A resnet18 cIMLE checkpoint written by JAX's save_pytree (random
    weights from the port's init carried across: JAX's init is not under
    test)."""
    path = os.path.join(root, "jax_resnet18.npz")
    model = init_depth_model(torch.Generator().manual_seed(3),
                             DepthModelConfig(backbone="resnet18",
                                              d_latent=LATENT), "cpu")
    save_pytree(path, depth_state_to_jax(model.state_dict()))
    return path


@pytest.mark.parametrize("select", ["first", "loss", "best_metric"])
def test_eval_cli_matches_jax(root, jax_ckpt, select, monkeypatch, capsys):
    argv = ["--dataroot", root, "--dataset", "evalset", "--backbone",
            "resnet18", "--load_ckpt", jax_ckpt, "--d_latent", str(LATENT),
            "--num_samples", "3", "--select", select, "--crop_size",
            str(CROP), "--seed", "2"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["depth_eval.py"] + argv)
    jax_depth_eval.main()
    want = _metrics(capsys.readouterr().out)
    key = jax.random.PRNGKey(2)

    def latents(i, k):
        return np.asarray(jax.random.normal(
            jax.random.fold_in(key, i * 100 + k), (1, LATENT)))

    got = depth_eval_torch.main(argv + ["--platform", "cpu"],
                                latents=latents)
    printed = _metrics(capsys.readouterr().out)
    assert got["images"] == 2 and set(got["metrics"]) == set(want)
    for k in want:
        assert abs(got["metrics"][k] - want[k]) <= 1e-4 + 5e-5, k
        assert printed[k] == round(got["metrics"][k], 4)


def test_clis_refuse_to_run_without_a_card_unasked(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        depth_train_torch.main(["--dataroot", root, "--dataset_list",
                                "demo"])
    with pytest.raises(RuntimeError, match="--platform cpu"):
        depth_eval_torch.main(["--dataroot", root, "--dataset", "evalset"])
