"""The PyTorch port's per-chunk frames (render_brick_mxu with kernel "n",
"t" and "tp") against the JAX frames in interpret mode on the same baked
field, at the 16x16 setup of tests/test_render_brick_mxu.py, mirroring
its :154, :168, :182, :272 and :350 (the segmented and exact-cull
frames are in test_torch_render_brick_exact.py).

Frame tolerance: rgb/opacity atol 2e-3, the tolerance JAX's own tests
hold two implementations of the same kernel function to; the counters
pairs_rendered, pairs_undrained, trunc_tiles and dma_slots must be
equal.  Within the port, the JAX tests' own frame invariants hold too
(banded = flat, drained = ample, segmented = flat)."""
import jax
import numpy as np
import pytest
import torch

from google_nerf_tpu.models.render_brick_mxu import \
    render_brick_mxu as jax_render
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models import render_brick_mxu as trbm
from google_nerf_tpu_torch.models.baked import bake
from test_torch_render_brick_mxu import _assert_frame, make_scene

BASE = dict(max_samples=64, T_threshold=1e-2, macro_tiles=0)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _frames(sc, baked=None, **kw):
    """The port's frame of `kw` on the scene, held against the JAX frame
    of the same kwargs."""
    kw = dict(BASE, **kw)
    jax_out = jax_render(sc["jbaked"], sc["jcfg"], sc["o"], sc["d"], 16, 16,
                         bcfg=sc["jbcfg"], interpret=True, **kw)
    out = trbm.render_brick_mxu(
        sc["baked"] if baked is None else baked, sc["cfg"],
        torch.as_tensor(np.array(sc["o"])),
        torch.as_tensor(np.array(sc["d"])), 16, 16, bcfg=sc["bcfg"],
        device="cpu", **kw)
    _assert_frame(out, jax_out)
    return out


def _close(a, b, atol):
    np.testing.assert_allclose(a["rgb"].numpy(), b["rgb"].numpy(), atol=atol)


@pytest.mark.parametrize("kernel,kw", [
    ("n", dict(L=64)),
    ("t", dict(L=64)),
    ("tp", dict(L=64, pbatch=4)),
    ("n", dict(L=64, bands=((1, 64), (1, 64), (2, 64)))),
    ("t", dict(L=64, bands="auto"))])
def test_dense_frame_matches_jax(scene, kernel, kw):
    """Flat and banded frames of K3, K4 and K2 (mirrors :154, :168 and
    :182; auto bands cut this frame's lists, so the drain runs too)."""
    out = _frames(scene, kernel=kernel, **kw)
    assert int(out["pairs_rendered"]) > 0
    assert np.all(np.isfinite(out["rgb"].numpy()))


def test_n_frame_matches_t_frame_and_banded(scene):
    """Within the port: n = t (2e-3, the JAX test's), and generous bands
    = the flat grid (1e-6), as tests/test_render_brick_mxu.py:168-202."""
    kw = dict(BASE, bcfg=scene["bcfg"], L=64, device="cpu")
    o = torch.as_tensor(np.array(scene["o"]))
    d = torch.as_tensor(np.array(scene["d"]))
    n = trbm.render_brick_mxu(scene["baked"], scene["cfg"], o, d, 16, 16,
                              kernel="n", **kw)
    t = trbm.render_brick_mxu(scene["baked"], scene["cfg"], o, d, 16, 16,
                              kernel="t", **kw)
    banded = trbm.render_brick_mxu(scene["baked"], scene["cfg"], o, d, 16,
                                   16, kernel="t",
                                   bands=((1, 64), (1, 64), (2, 64)), **kw)
    _close(n, t, 2e-3)
    _close(t, banded, 1e-6)
    assert int(n["pairs_rendered"]) == int(t["pairs_rendered"]) \
        == int(banded["pairs_rendered"])
    assert int(banded["pairs_undrained"]) == 0


def _port(sc, **kw):
    """The port's frame alone (plain versions on the CPU)."""
    return trbm.render_brick_mxu(
        sc["baked"], sc["cfg"], torch.as_tensor(np.array(sc["o"])),
        torch.as_tensor(np.array(sc["d"])), 16, 16, bcfg=sc["bcfg"],
        device="cpu", **dict(BASE, **kw))


DRAIN = dict(drained=dict(L=4, drain_tiles=4, drain_L=64),
             banded=dict(L=8, bands=((1, 8), (3, 4)), drain_tiles=4,
                         drain_L=64))


@pytest.mark.parametrize("variant", ["drained", "banded"])
@pytest.mark.parametrize("kernel", ["n", "t", "tp"])
def test_overflow_drain_matches_jax(scene, kernel, variant):
    """A list capacity of 4 (or a band capacity cut) truncates; the drain
    re-renders those tiles (mirrors :272) and restores the ample frame."""
    out = _frames(scene, kernel=kernel, **DRAIN[variant])
    assert int(out["pairs_undrained"]) == 0
    ample = _port(scene, kernel=kernel, L=64, drain_tiles=0)
    assert int(ample["trunc_tiles"]) == 0
    _close(out, ample, 1e-5)


def test_list_overflow_counted_without_drain(scene):
    """Drains off: a truncated list is counted, never certified (mirrors
    :350)."""
    cut = _frames(scene, kernel="tp", pbatch=2, L=4, drain_tiles=0)
    assert int(cut["pairs_undrained"]) > 0 and int(cut["trunc_tiles"]) > 0


def test_segment_slots_with_n_or_t_raise(scene):
    for kernel in ("n", "t"):
        with pytest.raises(ValueError, match="init-carry"):
            trbm.render_brick_mxu(scene["baked"], scene["cfg"],
                                  torch.zeros(256, 3), torch.ones(256, 3),
                                  16, 16, bcfg=scene["bcfg"], kernel=kernel,
                                  segment_slots=8, device="cpu")


def test_weights_end_to_end_n_frame_matches_jax(scene):
    """JAX init_ngp params -> params_from_jax -> port bake -> port n frame
    (the default kernel) agrees with the all-JAX frame."""
    tree = jax.tree_util.tree_map(np.asarray, scene["params"])
    params = params_from_jax(tree, device="cpu")
    baked = bake(params, scene["cfg"], torch.as_tensor(
        np.array(scene["occ"])), scene["bcfg"], device="cpu")
    out = _frames(scene, baked=baked, L=64, exact_cull=16, drain_tiles=4,
                  drain_L=64, drain_xc=32)
    assert int(out["pairs_undrained"]) == 0
