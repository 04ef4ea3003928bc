"""The PyTorch port's segmented and exact-cull per-chunk frames against
the JAX frames in interpret mode, mirroring tests/test_render_brick_mxu.py
:328, :455, :480 and :496, with the setup and tolerances of
test_torch_render_brick_dense.py (rgb/opacity atol 2e-3 and equal
counters against JAX; the JAX tests' own invariants within the port)."""
import pytest

from test_torch_render_brick_dense import _close, _frames, _port
from test_torch_render_brick_mxu import make_scene


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_segmented_frame_matches_jax(scene):
    """Segments with dead-tile elision through K2's init carry (mirrors
    :328): the port and JAX agree, and segmented = flat in the port."""
    seg = _frames(scene, kernel="tp", pbatch=2, L=64, segment_slots=8)
    flat = _port(scene, kernel="tp", pbatch=2, L=64)
    _close(seg, flat, 1e-6)
    assert int(seg["dma_slots"]) <= int(flat["dma_slots"])


@pytest.mark.parametrize("xc", [64, 8])
@pytest.mark.parametrize("kernel", ["t", "tp"])
def test_exact_cull_matches_jax(scene, kernel, xc):
    """The exact hit filter at ample and tight capacity (mirrors :455):
    the filtered frame equals the unfiltered one."""
    kw = dict(kernel=kernel, drain_tiles=4, drain_L=64, L=64)
    ex = _frames(scene, exact_cull=xc, **kw)
    assert int(ex["pairs_undrained"]) == 0
    _close(ex, _port(scene, **kw), 1e-5)


@pytest.mark.parametrize("variant", [
    dict(segment_slots=8), dict(bands=((1, 16), (3, 8)), drain_xc=64)])
def test_exact_cull_segments_and_bands_match_jax(scene, variant):
    """Exact filter with segments (mirrors :480) and with bands and the
    exact-culled drain (mirrors :496), against the ample flat frame."""
    kw = dict(kernel="tp", pbatch=2, L=64, drain_tiles=4, drain_L=64)
    out = _frames(scene, exact_cull=16, **variant, **kw)
    assert int(out["pairs_undrained"]) == 0
    _close(out, _port(scene, **kw), 1e-5)
