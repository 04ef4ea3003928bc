"""SSIM and LPIPS in the PyTorch port against google_nerf_tpu/eval/metrics.py
on the same numpy inputs.

SSIM: rtol 1e-5 (float32 convolutions summed in another order).  LPIPS on
random-init weights of the converter's shapes (the weights of
tests/test_lpips_golden.py): rtol 1e-4, the tolerance that test holds
JAX's graph to against torch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.eval import metrics as jm
from google_nerf_tpu_torch.eval import metrics as tm


def _random_weights(rng):
    """Random-init weights with the converter's shapes (conv OIHW, lin
    heads non-negative), as tests/test_lpips_golden.py builds them."""
    w, cin, li, taps = {}, 3, 0, []
    for widths in tm._VGG_BLOCKS:
        for cout in widths:
            w[f"conv{li}_w"] = rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(
                np.float32)
            w[f"conv{li}_b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
            cin, li = cout, li + 1
        taps.append(cin)
    for j, c in enumerate(taps):
        w[f"lin{j}_w"] = np.abs(rng.normal(0, 0.05, (1, c, 1, 1))).astype(
            np.float32)
    return w


def _images(seed, shape, noise=0.1):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 3, 17, 23)],
                         ids=["hwc", "nchw"])
def test_ssim_equals_jax(shape):
    pred, gt = _images(0, shape)
    want = float(jm.ssim(jnp.asarray(pred), jnp.asarray(gt)))
    got = tm.ssim(torch.as_tensor(pred), torch.as_tensor(gt))
    assert got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(tm.ssim(torch.as_tensor(gt), torch.as_tensor(gt))) == \
        pytest.approx(1.0, abs=1e-5)


def test_lpips_impl_equals_jax():
    rng = np.random.default_rng(0)
    w = _random_weights(rng)
    x = rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    want = float(jm._lpips_impl({k: jnp.asarray(v) for k, v in w.items()},
                                jnp.asarray(x), jnp.asarray(y)))
    tw = {k: torch.as_tensor(v) for k, v in w.items()}
    got = float(tm._lpips_impl(tw, torch.as_tensor(x), torch.as_tensor(y)))
    assert got == pytest.approx(want, rel=1e-4)
    # the scorer on (H, W, 3) images in [0, 1], as JAX's LPIPS class
    pred, gt = _images(1, (32, 32, 3), noise=0.2)
    scorer = tm.LPIPS(device="cpu")
    scorer.weights = tw
    jscorer = jm.LPIPS()
    jscorer.weights = {k: jnp.asarray(v) for k, v in w.items()}
    assert float(scorer(torch.as_tensor(pred), torch.as_tensor(gt))) == \
        pytest.approx(float(jscorer(pred, gt)), rel=1e-4)


def test_lpips_identical_images_and_no_weights():
    rng = np.random.default_rng(1)
    w = {k: torch.as_tensor(v) for k, v in _random_weights(rng).items()}
    x = torch.as_tensor(rng.uniform(-1, 1, (1, 3, 32, 32)).astype(
        np.float32))
    assert float(tm._lpips_impl(w, x, x)) == pytest.approx(0.0, abs=1e-7)
    scorer = tm.LPIPS(weights_path=None)
    assert not scorer.available
    assert scorer(torch.zeros(8, 8, 3), torch.zeros(8, 8, 3)) is None


def test_lpips_weights_load_from_npz(tmp_path):
    """load_lpips_weights reads the converter's npz layout."""
    w = _random_weights(np.random.default_rng(2))
    np.savez(tmp_path / "w.npz", **w)
    scorer = tm.LPIPS(str(tmp_path / "w.npz"), device="cpu")
    assert scorer.available
    img = torch.rand(32, 32, 3, generator=torch.Generator().manual_seed(0))
    assert float(scorer(img, img)) == pytest.approx(0.0, abs=1e-6)
