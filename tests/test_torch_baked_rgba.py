"""The PyTorch port's per-frame RGBA bake and K5 frame
(models/baked_rgba.py) against the JAX package, mirroring
tests/test_render_brick_mxu.py:405, :425 and :440.

Tolerances: the pre-shaded slabs' sigma lanes are copies of bf16 pool
values and must be equal; their rgb lanes are sigmoid(MLP) rounded once
to bf16, and the two sides' f32 matmuls sum in different orders, so a
value can round to the neighbouring bf16: atol 4e-3 (one bf16 step below
1 is 2^-8).  Frames: rgb/opacity atol 2e-3 and equal counters, as for
the other frames."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.models import baked_rgba as jrgba
from google_nerf_tpu.models.render_brick_mxu import \
    render_brick_mxu as jax_render
from google_nerf_tpu_torch.models import baked_rgba as trgba
from google_nerf_tpu_torch.models import render_brick_mxu as trbm
from test_torch_render_brick_mxu import (_assert_frame, jax_bf16_to_torch,
                                         make_scene)

BASE = dict(max_samples=64, T_threshold=1e-2, macro_tiles=0, L=64)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _rays(sc):
    return (torch.as_tensor(np.array(sc["o"])),
            torch.as_tensor(np.array(sc["d"])))


def test_corner_grid_roundtrip_matches_jax():
    """_rows_from_grid then _corner_grid returns the corner grid exactly,
    and both equal the JAX functions (mirrors :440)."""
    rng = np.random.RandomState(3)
    Bk, F, nb = 4, 5, 3
    G = rng.randn(nb, Bk + 1, Bk + 1, Bk + 1, F).astype(np.float32)
    rows = trgba._rows_from_grid(torch.as_tensor(G), Bk)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jrgba._rows_from_grid(jnp.asarray(G), Bk)))
    back = trgba._corner_grid(rows.reshape(nb, Bk ** 3, 8 * F), Bk, F)
    np.testing.assert_array_equal(back.numpy(), G)


def test_bake_rgba_matches_jax(scene):
    """The port's per-frame bake of the JAX scene's pool, for one camera
    origin, against JAX's bake_rgba."""
    cam_o = np.array(scene["o"])[0]
    want = jax_bf16_to_torch(jrgba.bake_rgba(
        scene["jbaked"], scene["jcfg"], scene["jbcfg"], jnp.asarray(cam_o)))
    got = trgba.bake_rgba(scene["baked"], scene["cfg"], scene["bcfg"],
                          torch.as_tensor(cam_o))
    assert got.shape == want.shape == (scene["baked"]["n_blocks"], 32, 512)
    assert got.dtype == torch.bfloat16
    g = got.float().view(-1, 8, 4, 512)
    w = want.float().view(-1, 8, 4, 512)
    torch.testing.assert_close(g[:, :, 0], w[:, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(g[:, :, 1:], w[:, :, 1:], rtol=0, atol=4e-3)


@pytest.mark.parametrize("kw", [dict(bands=()), dict(segment_slots=8)])
def test_rgba_frame_matches_jax(scene, kw):
    """render_brick_mxu_rgba, flat (mirrors :405) and segmented (mirrors
    :425), against the JAX frame; segmented = flat in the port."""
    o, d = _rays(scene)
    jax_out = jrgba.render_brick_mxu_rgba(
        dict(scene["jbaked"]), scene["jcfg"], scene["o"], scene["d"], 16, 16,
        bcfg=scene["jbcfg"], interpret=True, **BASE, **kw)
    baked = dict(scene["baked"])
    out = trgba.render_brick_mxu_rgba(baked, scene["cfg"], o, d, 16, 16,
                                      bcfg=scene["bcfg"], device="cpu",
                                      **BASE, **kw)
    assert "poolRGBA" in baked                    # baked inside the frame
    _assert_frame(out, jax_out)
    assert int(out["pairs_undrained"]) == 0
    flat = trbm.render_brick_mxu(baked, scene["cfg"], o, d, 16, 16,
                                 bcfg=scene["bcfg"], kernel="rgba",
                                 device="cpu", **BASE)
    np.testing.assert_allclose(out["rgb"].numpy(), flat["rgb"].numpy(),
                               atol=1e-6)
    assert int(out["dma_slots"]) <= int(flat["dma_slots"])


def test_rgba_frame_sigma_matches_t_frame(scene):
    """The rgba path's sigma field is the feature pool's, so opacity
    tracks the t frame tightly; rgb differs only by the baked-shading
    approximation (mirrors :405's bounds)."""
    o, d = _rays(scene)
    ref = trbm.render_brick_mxu(scene["baked"], scene["cfg"], o, d, 16, 16,
                                bcfg=scene["bcfg"], kernel="t",
                                device="cpu", **BASE)
    got = trgba.render_brick_mxu_rgba(dict(scene["baked"]), scene["cfg"], o,
                                      d, 16, 16, bcfg=scene["bcfg"],
                                      device="cpu", **BASE)
    np.testing.assert_allclose(got["opacity"].numpy(),
                               ref["opacity"].numpy(), atol=2e-2)
    assert float((got["rgb"] - ref["rgb"]).abs().mean()) < 0.12
    assert int(got["pairs_undrained"]) == 0
