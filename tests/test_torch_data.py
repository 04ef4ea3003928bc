"""The port's procedural synthetic dataset against JAX's: K, directions,
poses, ground-truth images and alphas.  Each side renders its ground
truth fresh into its own cache directory (the JAX cache stores float16,
so a cached JAX read would differ by more than fp32 rounding)."""
import jax.numpy as jnp
import numpy as np
import torch

from google_nerf_tpu.data import synthetic as js
from google_nerf_tpu_torch.data import synthetic as ts


def test_synthetic_dataset_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GNT_GT_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(tmp_path / "torch"))
    kw = dict(split="test", n_images=1, img_wh=(16, 16), style="textured")
    want = js.SyntheticDataset(**kw)
    got = ts.SyntheticDataset(device="cpu", **kw)
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_allclose(got.directions, want.directions, atol=1e-7)
    np.testing.assert_allclose(got.alphas, want.alphas, atol=1e-5)
    np.testing.assert_allclose(got.rays, want.rays, atol=1e-5)
    assert 0.0 < float(got.alphas.mean()) < 1.0
    # a second dataset reads the port's float32 cache back unchanged
    assert list((tmp_path / "torch").glob("*.npz"))
    again = ts.SyntheticDataset(device="cpu", **kw)
    np.testing.assert_array_equal(again.rays, got.rays)


def test_analytic_field_matches_jax():
    x = np.random.RandomState(0).uniform(-0.5, 0.5, (500, 3)) \
        .astype(np.float32)
    for style in ("solid", "shell", "textured"):
        sig, rgb = ts.analytic_field(torch.as_tensor(x), style)
        jsig, jrgb = js.analytic_field(jnp.asarray(x), style)
        np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), atol=1e-3,
                                   rtol=1e-5)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
