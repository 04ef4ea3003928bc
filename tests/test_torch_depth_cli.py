"""The port's depth CLIs against JAX's on one processed scan and one JAX
checkpoint, on the CPU: depth_test.py -> depth_test_torch.py and
depth_eval_scannet.py -> depth_eval_scannet_torch.py.

The scan: three 96x72 JPEG frames (the port's encoder) in rgb/ and
16-bit mm PNGs of 48x36 in depth/; the checkpoint: JAX's init of
resnet50 at crop 64 written by JAX's save_pytree (.npz), which both CLIs
load whole.  Both CLIs decode the JPEGs themselves (cv2 and the port's
codec, equal here) and resize with cv2's sample positions.

Tolerances: the .npy priors atol 1e-5 + rtol 1e-5 (the f32 forward
summed in another order; seen 2.1e-6 of a prior's largest value); the
16-bit PNG within 1 count (a truncation); the rainbow
PNG exactly matplotlib's map of the port's own prior (.npy), and within
one step of the 256-entry map (4 counts) of JAX's, whose depth differs
in the last bits; the metric battery within 1e-4.  A cIMLE case (d_latent
8, three hypotheses in minibatches of 5 and of 1) passes JAX's latents
through the CLI's `latents` hook."""
import os
import sys

import jax
import matplotlib
import numpy as np
import pytest

import depth_eval_scannet as jax_eval_scannet
import depth_eval_scannet_torch
import depth_test as jax_depth_test
import depth_test_torch
from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import init_depth_model as jax_init
from google_nerf_tpu.utils.ckpt import save_pytree
from google_nerf_tpu_torch.utils.image import read_image, write_jpeg, write_png

CROP = 64
WH = (96, 72)


def _scan(root):
    """rgb/ of three textured 96x72 JPEGs, depth/ of 48x36 mm PNGs."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    yy, xx = np.mgrid[0:WH[1], 0:WH[0]]
    for i in range(3):
        img = np.stack([np.sin(xx / (5 + i)) * 90 + 120,
                        np.cos(yy / (7 + i)) * 80 + 110,
                        (xx + yy * (i + 1)) % 200 + 20], -1)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        write_jpeg(os.path.join(root, "rgb", f"{i}.jpg"),
                   img.astype(np.uint8), quality=90)
        gt = 1000 + 2000 * rng.random((WH[1] // 2, WH[0] // 2))
        gt[:3, :5] = 0                                  # invalid pixels
        write_png(os.path.join(root, "depth", f"{i}.png"),
                  gt.astype(np.uint16))
    return root


def _ckpt(path, d_latent):
    cfg = JConfig(backbone="resnet50", d_latent=d_latent)
    variables = jax_init(jax.random.PRNGKey(3), cfg, (CROP, CROP))
    save_pytree(path, jax.tree_util.tree_map(np.asarray, variables))
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_cli")
    scene = _scan(str(root / "scene0000_00"))
    return dict(root=root, scene=scene,
                plain=_ckpt(str(root / "plain.npz"), 0),
                cimle=_ckpt(str(root / "cimle.npz"), 8))


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def _metrics(out):
    line = [l for l in out.splitlines() if l.startswith("metrics:")]
    assert len(line) == 1, out
    return eval(line[0][len("metrics:"):], {})   # a printed dict of floats


def test_cli_decodes_the_scan_as_cv2(world):
    import cv2
    for i in range(3):
        path = os.path.join(world["scene"], "rgb", f"{i}.jpg")
        np.testing.assert_array_equal(
            depth_test_torch.read_rgb01(path),
            cv2.imread(path)[..., ::-1].astype(np.float32) / 255.0)


def test_depth_test_matches_jax(world, monkeypatch):
    img_dir = os.path.join(world["scene"], "rgb")
    jout, tout = (str(world["root"] / d) for d in ("dt_jax", "dt_torch"))
    common = ["--img_dir", img_dir, "--backbone", "resnet50",
              "--load_ckpt", world["plain"], "--crop_size", str(CROP)]
    _run_jax(monkeypatch, jax_depth_test, common + ["--out_dir", jout])
    depth_test_torch.main(common + ["--out_dir", tout, "--platform", "cpu"])
    for i in range(3):
        jd = read_image(os.path.join(jout, f"{i}-depth.png")).astype(int)
        td = read_image(os.path.join(tout, f"{i}-depth.png")).astype(int)
        assert td.shape == (WH[1], WH[0]) and td.max() > 50000
        assert np.abs(jd - td).max() <= 1, np.abs(jd - td).max()
        jr = read_image(os.path.join(jout, f"{i}-depth_rainbow.png"))
        tr = read_image(os.path.join(tout, f"{i}-depth_rainbow.png"))
        assert tr.shape == (WH[1], WH[0], 3)
        diff = np.abs(jr.astype(int) - tr)
        assert diff.max() <= 4 and (diff > 0).mean() < 0.01, (
            diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("case", ["plain", "cimle"])
def test_depth_eval_scannet_matches_jax(world, monkeypatch, capsys, case):
    jout, tout = (str(world["root"] / f"es_{case}_{d}")
                  for d in ("jax", "torch"))
    flags = (["--d_latent", "0", "--num_samples", "1"] if case == "plain"
             else ["--d_latent", "8", "--num_samples", "6",
                   "--all_samples"])
    common = ["--scene_dir", world["scene"], "--backbone", "resnet50",
              "--load_ckpt", world[case], "--crop_size", str(CROP),
              "--save_rainbow", "--seed", "2"] + flags
    capsys.readouterr()
    _run_jax(monkeypatch, jax_eval_scannet, common + ["--out_dir", jout])
    jm = _metrics(capsys.readouterr().out)

    key = jax.random.PRNGKey(2)

    def jax_latents(fi, start, m):
        return np.asarray(jax.random.normal(
            jax.random.fold_in(key, fi * 100 + start), (m, 8)))

    got = depth_eval_scannet_torch.main(
        common + ["--out_dir", tout, "--platform", "cpu"],
        latents=jax_latents if case == "cimle" else None)
    tm = _metrics(capsys.readouterr().out)
    assert got["frames"] == 3 and set(got["metrics"]) == set(jm)
    for k in jm:
        assert abs(got["metrics"][k] - jm[k]) <= 1e-4, k
        assert abs(round(got["metrics"][k], 4) - tm[k]) <= 1e-12
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout))
    n_npy = 3 * (6 if case == "cimle" else 1)
    assert len([n for n in names if n.endswith(".npy")]) == n_npy
    for n in names:
        if n.endswith(".npy"):
            j, t = np.load(os.path.join(jout, n)), np.load(
                os.path.join(tout, n))
            assert t.shape == (WH[1], WH[0]) and t.dtype == np.float32
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=n)
    for i in range(3):
        d0 = np.load(os.path.join(tout, f"{i}.npy"))
        dn = (d0 - d0.min()) / max(d0.max() - d0.min(), 1e-8)
        want = (matplotlib.colormaps["rainbow"](dn)[..., :3]
                * 255).astype(np.uint8)
        np.testing.assert_array_equal(
            read_image(os.path.join(tout, f"{i}-depth_rainbow.png")), want)
    if case == "cimle":
        # the hypotheses differ
        p = np.stack([np.load(os.path.join(tout, f"0-sample{k}.npy"))
                      for k in range(1, 6)])
        assert np.abs(p[0] - p[1]).max() > 1e-3


def test_cimle_latents_come_from_the_seed(world, monkeypatch):
    """Without the hook the latents are the --seed generator's: one
    seed gives the same priors, another seed others."""
    out = {}
    for tag, seed in (("a", 0), ("b", 0), ("c", 1)):
        d = str(world["root"] / f"seed_{tag}")
        depth_eval_scannet_torch.main(
            ["--scene_dir", world["scene"], "--backbone", "resnet50",
             "--load_ckpt", world["cimle"], "--crop_size", str(CROP),
             "--d_latent", "8", "--seed", str(seed), "--out_dir", d,
             "--platform", "cpu"])
        out[tag] = np.load(os.path.join(d, "1.npy"))
    np.testing.assert_array_equal(out["a"], out["b"])
    assert np.abs(out["a"] - out["c"]).max() > 1e-4


def test_clis_refuse_to_run_without_a_card_unasked(world, monkeypatch):
    monkeypatch.setattr(depth_test_torch.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        depth_test_torch.main(["--img_dir", world["scene"]])
    with pytest.raises(RuntimeError, match="--platform cpu"):
        depth_eval_scannet_torch.main(["--scene_dir", world["scene"],
                                       "--out_dir", "x"])

