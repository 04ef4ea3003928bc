"""The one-shot test renderer in the PyTorch port against JAX's
render_test_oneshot on the same params, occupancy and rays (the fixture
of tests/test_oneshot.py: grid 32, a 4-level packed table of 2^12 rows
scaled by 2e3, a 24x20 view, 15% occupancy).

Each case of tests/test_oneshot.py is run on both sides: rgb, opacity
and depth within atol 2e-3 (PERF.md's frame tolerance: the samples are
the same, sums run in another order); drain_trips and alive_after_main
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.core.rays import get_rays
from google_nerf_tpu.data.synthetic import SyntheticDataset
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.models.ngp import init_ngp
from google_nerf_tpu.models.render_test_oneshot import \
    render_test_oneshot as jax_oneshot
from google_nerf_tpu.ops.grid import pack_occupancy_blocks, pack_occupancy_u8
from google_nerf_tpu.ops.march_block import pack_occupancy_block2
from google_nerf_tpu.ops.march_seg import required_dilation_radius
from google_nerf_tpu_torch.convert import params_from_jax
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.models.render_test_oneshot import \
    render_test_oneshot

MS = 256
SEG = dict(march="seg", k=16, n_keep=8, sup=4, n_keep_sup=8)
BLOCK2 = dict(march="block2", k=16, n_keep=8, budget_div=0, straggler_div=2,
              drain=True)
# The cases share chunk sizes where they can, so that JAX's jitted passes
# compile once for several of them.
CASES = {
    # tests/test_oneshot.py::test_oneshot_matches_fast (budget-packed)
    "seg": dict(SEG, chunk=480, passes=3, straggler_div=2),
    # ::test_pooled_stragglers_multichunk_matches_fast
    "pooled_multichunk": dict(SEG, chunk=240, passes=4, straggler_div=1),
    # ::test_dense_pass_matches_packed, both sides of it
    "dense_pass": dict(SEG, chunk=240, passes=3, straggler_div=1,
                       budget_div=0),
    "budget_pack": dict(SEG, chunk=240, passes=3, straggler_div=1,
                        budget_div=1),
    # each chunk with its own straggler passes
    "per_chunk": dict(SEG, chunk=480, passes=3, straggler_div=2,
                      pooled_stragglers=False),
    # ::test_drain_matches_fast_with_tiny_pool: 8 rays a trip
    "drain_tiny_pool": dict(SEG, chunk=128, straggler_div=16, budget_div=0,
                            drain=True, max_passes=4096),
    # ::test_oneshot_block2_matches_block, both sides of it
    "block2": dict(BLOCK2, chunk=480),
    "block": dict(BLOCK2, chunk=480, march="block"),
    # ::test_oneshot_compact_main_matches
    "compact_main": dict(BLOCK2, chunk=480, compact_main=True),
    # ::test_drain_budget_pack_matches_dense
    "drain_budget_pack": dict(BLOCK2, chunk=480, compact_main=True,
                              drain_budget_div=8),
}


@pytest.fixture(scope="module")
def scene():
    jcfg = JNGPConfig(scale=0.5, encoder="packed", grid_size=32,
                      packed_log2_size=12, packed_levels=4)
    params = init_ngp(jax.random.PRNGKey(0), jcfg)
    params["packed_table"] = params["packed_table"] * 2e3
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(24, 20))
    o, d = get_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    occ = jax.random.bernoulli(jax.random.PRNGKey(3), 0.15,
                               (jcfg.cascades,) + (jcfg.grid_size,) * 3)
    occ_u8 = pack_occupancy_u8(
        occ, required_dilation_radius(8, jcfg.grid_size, MS, jcfg.scale),
        super_radius=required_dilation_radius(32, jcfg.grid_size, MS,
                                              jcfg.scale))
    occ2 = pack_occupancy_block2(occ, max_samples=MS, scale=jcfg.scale)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    return dict(
        jcfg=jcfg, params=params, o=o, d=d,
        occ={"seg": occ_u8, "block2": occ2,
             "block": pack_occupancy_blocks(occ)},
        cfg=NGPConfig(scale=0.5, encoder="packed", grid_size=32,
                      packed_log2_size=12, packed_levels=4),
        tparams=tparams, to=torch.as_tensor(np.array(o)),
        td=torch.as_tensor(np.array(d)),
        tocc={"seg": torch.as_tensor(np.array(occ_u8)),
              "block": torch.as_tensor(np.array(pack_occupancy_blocks(occ))),
              "block2": {k: torch.as_tensor(np.array(v))
                         for k, v in occ2.items()}})


def render_both(sc, params=None, tparams=None, apply_fn=None,
                tapply_fn=None, **kw):
    occ = kw["march"]
    want = jax_oneshot(sc["params"] if params is None else params,
                       sc["jcfg"], sc["occ"][occ], sc["o"], sc["d"],
                       max_samples=MS, T_threshold=1e-4, apply_fn=apply_fn,
                       **kw)
    got = render_test_oneshot(sc["tparams"] if tparams is None else tparams,
                              sc["cfg"], sc["tocc"][occ], sc["to"], sc["td"],
                              max_samples=MS, T_threshold=1e-4,
                              apply_fn=tapply_fn, **kw)
    return got, want


def assert_frames_agree(got, want, atol=2e-3):
    for k in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)
    for k in ("drain_trips", "alive_after_main"):
        assert (k in got) == (k in want)
        if k in want:
            assert int(got[k]) == int(want[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_oneshot_equals_jax(scene, case):
    got, want = render_both(scene, **CASES[case])
    assert_frames_agree(got, want)
    assert float(got["opacity"].max()) > 0.1     # the view has content
    if CASES[case].get("drain"):
        assert got["drain_trips"] > 1


def test_block_march_names_its_item(scene):
    """march="block" renders (it raised before the one-phase marcher was
    ported): the same image as block2 on the same occupancy, rgb and
    opacity within 1e-4 (tests/test_oneshot.py::
    test_oneshot_block2_matches_block's bound: one candidate lattice, the
    super phase a conservative superset)."""
    kw = dict(max_samples=MS, T_threshold=1e-4, k=16, n_keep=8, chunk=480,
              passes=1, budget_div=0, straggler_div=2, drain=True)
    ref = render_test_oneshot(scene["tparams"], scene["cfg"],
                              scene["tocc"]["block"], scene["to"],
                              scene["td"], march="block", **kw)
    got = render_test_oneshot(scene["tparams"], scene["cfg"],
                              scene["tocc"]["block2"], scene["to"],
                              scene["td"], march="block2", **kw)
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(ref["opacity"].max()) > 0.1
