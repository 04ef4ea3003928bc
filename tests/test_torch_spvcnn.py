"""The port's shape refiners against JAX's: the SPVCNN sparse executor
(depth/spvcnn.py, the cases of tests/test_spvcnn.py), the dense voxelnet
regressor (depth/voxelnet.py) and depth_shape_torch.py against
depth_shape.py, on JAX-carried weights.

JAX's spvcnn_apply costs a compile of ~30 s a shape on an 8-core CPU, so
every JAX call of this file runs at one shape: N_CAP rows, 5 input
channels and channel ratio 0.25.  A 3-channel head runs there with its
stem weights and its features padded with zero columns (their products
are exact zeros: the logits are the head's own).  The refiners
voxelize at N_CAP on both sides (JAX's refine_shift_runs at 65,536 rows
takes ~85 s in the six-worker suite on 8 cores).

Tolerances: voxelize, the parameters through either converter and the
sparse levels are exact; a logit within atol 1e-5 + rtol 1e-5 of JAX's
(f32 sums in another order: the segment mean is an index_add_ where JAX
differences a cumulative sum) and within JAX's own 2e-4 of the float64
dict oracle; the port's logits at two paddings are equal.  voxelnet: the
voxel features (means of fractions in [-0.5, 0.5), summed in another
order) within 1e-5, the regressor's eval-mode outputs within 1e-5 of
flax's; in train mode, both in float64, its outputs within rtol 1e-9
and its running statistics within rtol 1e-6 of flax's cast to float32
(in float32, train-mode BatchNorm's batch statistics at the last stage,
16 samples a channel, moved the output 7.7e-5 between one and eight
intra-op threads).  The CLI: the printed
shift within 1e-4 and focal within rtol 1e-4 (printed to 4 decimals and
to 0.1), the 16-bit PNG within 2 counts of 60,000 and the PLY's points
within rtol 1e-5 (the depth network's f32 sums in another order;
tests/test_torch_depth_model.py holds it at 1e-5); the three-step
refinement within 1e-5."""
import functools
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depth_shape as jax_depth_shape
import depth_shape_torch
from google_nerf_tpu.depth import model as jax_model
from google_nerf_tpu.depth import spvcnn as jsp
from google_nerf_tpu.depth import voxelnet as jvn
from google_nerf_tpu_torch.convert import (depth_state_to_jax,
                                           spvcnn_from_jax,
                                           voxelnet_state_from_jax)
from google_nerf_tpu_torch.depth import spvcnn as tsp
from google_nerf_tpu_torch.depth import voxelnet as tvn
from google_nerf_tpu_torch.depth.model import DepthModelConfig
from google_nerf_tpu_torch.utils.image import read_image, write_png
from test_spvcnn import oracle

N_CAP, CH, CR = 160, 5, 0.25
JAX_APPLY = jsp.spvcnn_apply


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_apply(params, coords, feats, valid):
    """JAX's spvcnn_apply at the file's one shape, a head of fewer input
    channels padded with zeros to CH."""
    params = _np(params)
    c = feats.shape[1]
    if c < CH:
        w = params["stem"][0]["conv"]
        pad = np.zeros((w.shape[0], CH - c, w.shape[2]), np.float32)
        stem0 = dict(params["stem"][0], conv=np.concatenate([w, pad], 1))
        params = dict(params, stem=[stem0, params["stem"][1]])
        feats = np.concatenate(
            [feats, np.zeros((feats.shape[0], CH - c), np.float32)], 1)
    assert coords.shape[0] == N_CAP
    return np.asarray(JAX_APPLY(jax.tree_util.tree_map(jnp.asarray, params),
                                jnp.asarray(coords), jnp.asarray(feats),
                                jnp.asarray(valid)))


def _cloud(n=120, span=60, c=CH, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, span, size=(n, 3)).astype(np.int32)
    key = (coords[:, 0] * 1024 + coords[:, 1]) * 1024 + coords[:, 2]
    _, first = np.unique(key, return_index=True)
    coords = coords[np.sort(first)]
    feats = rng.normal(size=(coords.shape[0], c)).astype(np.float32)
    return coords, feats


def _pad(coords, feats, n_cap):
    pad = n_cap - coords.shape[0]
    return (np.concatenate([coords, np.zeros((pad, 3), np.int32)]),
            np.concatenate([feats, np.zeros((pad, feats.shape[1]),
                                            np.float32)]),
            np.arange(n_cap) < coords.shape[0])


def _torchsparse_state_dict(rng, cs, inc0):
    """A state dict by the reference's module names in torchsparse's
    layout ((k^3, inc, outc); a 1^3 kernel (inc, outc)) with BatchNorm
    statistics off identity."""
    sd = {}

    def conv(name, k, inc, outc):
        sd[name + ".kernel"] = (rng.normal(
            size=(k ** 3, inc, outc) if k > 1 else (inc, outc))
            * 0.2).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = (1 + 0.2 * rng.normal(size=c)).astype(
            np.float32)
        sd[name + ".bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[name + ".running_mean"] = (0.1 * rng.normal(size=c)).astype(
            np.float32)
        sd[name + ".running_var"] = (1 + rng.random(c)).astype(np.float32)

    conv("stem.0", 3, inc0, cs[0]); bn("stem.1", cs[0])
    conv("stem.3", 3, cs[0], cs[0]); bn("stem.4", cs[0])
    for si, (inc, outc) in enumerate(zip(cs[:4], cs[1:]), start=1):
        conv(f"stage{si}.0.net.0", 2, inc, inc); bn(f"stage{si}.0.net.1", inc)
        conv(f"stage{si}.1.net.0", 3, inc, outc)
        bn(f"stage{si}.1.net.1", outc)
        conv(f"stage{si}.1.net.3", 3, outc, outc)
        bn(f"stage{si}.1.net.4", outc)
        if inc != outc:
            conv(f"stage{si}.1.downsample.0", 1, inc, outc)
            bn(f"stage{si}.1.downsample.1", outc)
        conv(f"stage{si}.2.net.0", 3, outc, outc)
        bn(f"stage{si}.2.net.1", outc)
        conv(f"stage{si}.2.net.3", 3, outc, outc)
        bn(f"stage{si}.2.net.4", outc)
    sd["point_transforms.0.0.weight"] = (rng.normal(
        size=(cs[4], cs[0])) * 0.2).astype(np.float32)
    sd["point_transforms.0.0.bias"] = (0.1 * rng.normal(size=cs[4])).astype(
        np.float32)
    bn("point_transforms.0.1", cs[4])
    sd["classifier.0.weight"] = (rng.normal(size=(1, cs[4])) * 0.2).astype(
        np.float32)
    sd["classifier.0.bias"] = np.full(1, 0.1, np.float32)
    return sd


def _jax_head(seed, channels):
    """A head in JAX's layout at channel ratio CR: JAX's converter on a
    torchsparse state dict drawn with numpy from `seed` (BatchNorm off
    identity), numpy leaves."""
    sd = _torchsparse_state_dict(np.random.default_rng(seed),
                                 [int(CR * c) for c in tsp.CS], channels)
    return _np(jsp.convert_spvcnn_state_dict(sd, cr=CR))


@pytest.fixture(scope="module")
def params5():
    return _jax_head(0, CH)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spvcnn_matches_dict_oracle_and_jax(params5):
    coords, feats = _cloud()
    cp, fp, vp = _pad(coords, feats, N_CAP)
    got = tsp.spvcnn_apply(spvcnn_from_jax(params5), cp, fp, vp).numpy()
    _close(got, jax_apply(params5, cp, fp, vp))
    np.testing.assert_allclose(got, oracle(params5, coords, feats),
                               rtol=2e-4, atol=2e-4)
    assert tsp.active_sites(cp, vp)[0] == coords.shape[0]


def test_spvcnn_padding_invariance(params5):
    """The port at two paddings gives one logit (it computes on the
    valid rows alone), JAX's at N_CAP."""
    coords, feats = _cloud(n=60, span=40, seed=1)
    tp = spvcnn_from_jax(params5)
    runs = [tsp.spvcnn_apply(tp, *_pad(coords, feats, n)).numpy()
            for n in (96, 200)]
    np.testing.assert_array_equal(runs[0], runs[1])
    _close(runs[0], jax_apply(params5, *_pad(coords, feats, N_CAP)))


def test_spvcnn_drops_out_of_range_sites_as_jax(params5):
    """Coordinates at or past 2^10 are marked invalid by the key, valid
    as the voxelizer made them (a cloud wider than ~10 m at 0.01)."""
    coords, feats = _cloud(n=100, span=40, seed=2)
    coords[::7, 0] += 1020
    cp, fp, vp = _pad(coords, feats, N_CAP)
    got = tsp.spvcnn_apply(spvcnn_from_jax(params5), cp, fp, vp).numpy()
    _close(got, jax_apply(params5, cp, fp, vp))
    lost = int(((coords >= tsp.CMAX).any(1)).sum())
    assert lost > 0
    assert tsp.active_sites(cp, vp)[0] == coords.shape[0] - lost


def test_state_dict_loads_and_runs_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    cs = [int(CR * c) for c in tsp.CS]
    sd = _torchsparse_state_dict(rng, cs, CH)
    jp = _np(jsp.convert_spvcnn_state_dict(sd, cr=CR))
    tp = tsp.convert_spvcnn_state_dict(sd, cr=CR, device="cpu")
    jax.tree_util.tree_map(np.testing.assert_array_equal, jp,
                           jax.tree_util.tree_map(lambda t: t.numpy(), tp))
    # a checkpoint whose 3^3 kernels list their offsets in another order
    # reads back through offset_perm (JAX's converter raises on the 2^3
    # and 1^3 kernels with any permutation)
    perm = rng.permutation(27)
    shuffled = dict(sd)
    for k, v in sd.items():
        if k.endswith(".kernel") and v.ndim == 3 and v.shape[0] == 27:
            shuffled[k] = np.empty_like(v)
            shuffled[k][perm] = v
    tperm = tsp.convert_spvcnn_state_dict(shuffled, cr=CR, offset_perm=perm,
                                          device="cpu")
    jax.tree_util.tree_map(torch.testing.assert_close, tperm, tp)
    with pytest.raises(IndexError):
        jsp.convert_spvcnn_state_dict(shuffled, cr=CR, offset_perm=perm)
    # a torch.save'd copy reloads with weights_only
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "head.pth")
    again = tsp.convert_spvcnn_state_dict(
        torch.load(tmp_path / "head.pth", weights_only=True), cr=CR,
        device="cpu")
    jax.tree_util.tree_map(torch.testing.assert_close, again, tp)
    coords, feats = _cloud(n=40, span=50, seed=3)
    cp, fp, vp = _pad(coords, feats, N_CAP)
    got = tsp.spvcnn_apply(again, cp, fp, vp).numpy()
    assert got.shape == (1,) and np.isfinite(got).all()
    _close(got, jax_apply(jp, cp, fp, vp))


def test_voxelize_dedups_first_as_jax():
    pts = np.array([[0.0, 0.0, 0.0], [0.004, 0.0, 0.0], [0.1, 0.0, 0.0]])
    feats = np.array([[1.0], [2.0], [3.0]])
    coords, f, valid = tsp.voxelize(pts, feats, voxel_size=0.01, n_cap=8)
    assert valid.sum() == 2          # the first two share a voxel
    assert f[0, 0] == 1.0            # the FIRST point is kept
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(3000, 3)) * 0.05
    cloud = np.concatenate([cloud, cloud[::3]])          # duplicates
    fe = rng.normal(size=(cloud.shape[0], 4))
    for n_cap in (8, 5000):                              # subsampled, not
        got = tsp.voxelize(cloud, fe, 0.01, n_cap=n_cap)
        want = jsp.voxelize(cloud, fe, 0.01, n_cap=n_cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("head", ["shift", "focal"])
def test_refiners_match_jax(monkeypatch, head):
    """refine_shift_spvcnn / refine_focal_spvcnn against JAX's, both
    voxelizing at N_CAP (the cloud's ~700 voxels subsampled by the
    seeded draw)."""
    for mod in (jsp, tsp):
        monkeypatch.setattr(mod, "voxelize",
                            functools.partial(mod.voxelize, n_cap=N_CAP))
    monkeypatch.setattr(jsp, "spvcnn_apply", jax_apply)
    rng = np.random.default_rng(0)
    depth = (1.0 + rng.random((24, 32))).astype(np.float32)
    depth[:2, :3] = 0.0                              # invalid pixels
    ch = 3 if head == "shift" else 5
    params = _jax_head(2, ch)
    tp = spvcnn_from_jax(params)
    cloud = tsp.shift_cloud if head == "shift" else tsp.focal_cloud
    coords, feats, valid = cloud(depth, 30.0, 16.0, 12.0)
    assert valid.all()                      # more voxels than N_CAP
    if head == "shift":
        got = tsp.refine_shift_spvcnn(depth, tp, 30.0, 16.0, 12.0)
        want = jsp.refine_shift_spvcnn(depth, params, 30.0, 16.0, 12.0)
        assert got <= 0.7
        np.testing.assert_allclose(
            tsp.refine_shift_spvcnn(depth, tp, 30.0, 16.0, 12.0,
                                    max_shift=-5.0), -5.0)
    else:
        got = tsp.refine_focal_spvcnn(depth, tp, 30.0, 16.0, 12.0)
        want = jsp.refine_focal_spvcnn(depth, params, 30.0, 16.0, 12.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- voxelnet

@pytest.fixture(scope="module")
def voxel_vars():
    """flax VoxelNetRegressor variables (cr 0.5, JAX's refiners' head)
    drawn with numpy in the tree flax's init lays out (its shapes by
    jax.eval_shape, which compiles nothing): kernels normal /
    sqrt(fan_in), BatchNorm affine and statistics off identity."""
    shapes = jax.eval_shape(jvn.VoxelNetRegressor(cr=0.5).init,
                            jax.random.PRNGKey(0), jnp.zeros((4, 4, 4, 4)))
    rng = np.random.default_rng(1)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            x = 1 + 0.3 * rng.random(shape)
        else:                              # bias, mean
            x = 0.1 * rng.normal(size=shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_voxelnet_forward_matches_flax(voxel_vars):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    valid = rng.random(700) > 0.2
    vj = np.asarray(jvn.voxelize_points(jnp.asarray(pts), jnp.asarray(valid),
                                        grid=32))
    vt = tvn.voxelize_points(torch.as_tensor(pts), torch.as_tensor(valid),
                             grid=32).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    model = tvn.VoxelNetRegressor(cr=0.5)
    model.load_state_dict(voxelnet_state_from_jax(voxel_vars), strict=True)
    model.eval()
    for positive in (True, False):
        want = np.asarray(jvn.VoxelNetRegressor(
            out_positive=positive).apply(voxel_vars, jnp.asarray(vj)))
        with torch.no_grad():
            got = model(torch.from_numpy(vj.copy()), positive).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # train mode, in float64 on both sides: batch statistics and flax's
    # running update (a float32 train-mode BatchNorm on 16 samples a
    # channel at the last stage moved the output 7.7e-5 with one intra-op
    # thread against eight: its sums in another order)
    batch = np.stack([vj, vj[::-1]]).astype(np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     voxel_vars)
        want, upd = jvn.VoxelNetRegressor().apply(
            v64, jnp.asarray(batch), train=True, mutable=["batch_stats"])
        want, upd = np.asarray(want), _np(upd)
    model.double().train()
    got = model(torch.from_numpy(batch)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    new = voxelnet_state_from_jax({"batch_stats": upd["batch_stats"]})
    own = model.state_dict()
    for k, v in new.items():     # flax's float64 statistics cast to f32
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(own[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9)


def test_voxelnet_refiners_match_jax(voxel_vars):
    rng = np.random.default_rng(1)
    depth = (1.0 + rng.random((24, 32))).astype(np.float32)
    depth[0, :4] = 0.0
    model = tvn.VoxelNetRegressor(cr=0.5)
    model.load_state_dict(voxelnet_state_from_jax(voxel_vars))
    model.eval()
    np.testing.assert_allclose(
        tvn.refine_shift(depth, model, 30.0, steps=2),
        jvn.refine_shift(depth, voxel_vars, 30.0, steps=2),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tvn.refine_focal(depth, model, 30.0, steps=2),
        jvn.refine_focal(depth, voxel_vars, 30.0, steps=2),
        rtol=1e-5, atol=1e-6)
    pts, valid = tvn.depth_to_pcd(depth, 30.0)
    jpts, jvalid = jvn.depth_to_pcd(depth, 30.0)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(valid, jvalid)


# ------------------------------------------------------------------ CLI

CROP = 32


def _image(root):
    yy, xx = np.mgrid[0:24, 0:32]
    img = np.stack([np.sin(xx / 5) * 90 + 120, np.cos(yy / 7) * 80 + 110,
                    (xx * 3 + yy * 5) % 200 + 20], -1).astype(np.uint8)
    os.makedirs(root)
    write_png(os.path.join(root, "a.png"), img)
    return root


def _ply_points(path):
    data = open(path, "rb").read()
    body = data[data.index(b"end_header\n") + len(b"end_header\n"):]
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    return rec["xyz"], rec["rgb"]


def _shift_focal(text):
    line = [l for l in text.splitlines() if "shift=" in l][-1]
    shift, focal = (float(w.split("=")[1]) for w in line.split())
    return shift, focal


def test_depth_shape_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """depth_shape_torch.py against depth_shape.py on one 32x24 image,
    resnet50 at crop 32, the port's random weights (seeds 0, 1, 2; heads
    at channel ratio CR) carried into JAX's CLI in place of its own
    init; both refiners voxelize at N_CAP."""
    imgs = _image(str(tmp_path / "imgs"))
    for mod in (jsp, tsp):
        monkeypatch.setattr(mod, "voxelize",
                            functools.partial(mod.voxelize, n_cap=N_CAP))
    monkeypatch.setattr(jsp, "spvcnn_apply", jax_apply)
    monkeypatch.setattr(depth_shape_torch, "init_spvcnn",
                        functools.partial(depth_shape_torch.init_spvcnn,
                                          cr=CR))
    depth_shape_torch.main(["--img_dir", imgs, "--out_dir",
                            str(tmp_path / "port"), "--backbone",
                            "resnet50", "--crop_size", str(CROP),
                            "--platform", "cpu"])
    ours = _shift_focal(capsys.readouterr().out)

    model, shift_p, focal_p = depth_shape_torch.build_models(
        DepthModelConfig(backbone="resnet50"), None, "cpu")
    variables = depth_state_to_jax(model.state_dict())
    heads = {3: _np(jax.tree_util.tree_map(lambda t: t.numpy(), shift_p)),
             5: _np(jax.tree_util.tree_map(lambda t: t.numpy(), focal_p))}
    monkeypatch.setattr(jax_model, "init_depth_model",
                        lambda *a, **k: variables)
    monkeypatch.setattr(jsp, "init_spvcnn",
                        lambda key, input_channel, **k: heads[input_channel])
    monkeypatch.setattr(sys, "argv", [
        "depth_shape.py", "--img_dir", imgs, "--out_dir",
        str(tmp_path / "jax"), "--backbone", "resnet50", "--crop_size",
        str(CROP)])
    jax_depth_shape.main()
    theirs = _shift_focal(capsys.readouterr().out)

    np.testing.assert_allclose(ours[0], theirs[0], atol=1e-4)   # printed
    np.testing.assert_allclose(ours[1], theirs[1], rtol=1e-4)   # to 0.1
    a = read_image(str(tmp_path / "port" / "a-depth_shifted.png"))
    b = cv2.imread(str(tmp_path / "jax" / "a-depth_shifted.png"),
                   cv2.IMREAD_UNCHANGED)
    assert a.dtype == b.dtype == np.uint16 and a.shape == (24, 32)
    assert np.abs(a.astype(int) - b).max() <= 2
    pa, ca = _ply_points(str(tmp_path / "port" / "a-pcd.ply"))
    pb, cb = _ply_points(str(tmp_path / "jax" / "a-pcd.ply"))
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-6)


def test_reconstruct3d_matches_jax(monkeypatch):
    """The three-step refinement on one depth map, both CLIs' function,
    on JAX-carried heads."""
    for mod in (jsp, tsp):
        monkeypatch.setattr(mod, "voxelize",
                            functools.partial(mod.voxelize, n_cap=N_CAP))
    monkeypatch.setattr(jsp, "spvcnn_apply", jax_apply)
    shift, focal = _jax_head(4, 3), _jax_head(5, CH)
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
    depth = (2.0 + np.sin(np.arange(24 * 32) / 40.0).reshape(24, 32)
             + 0.1 * rng.random((24, 32))).astype(np.float32)
    got = depth_shape_torch.reconstruct3d_from_depth(
        rgb, depth, spvcnn_from_jax(shift), spvcnn_from_jax(focal))
    want = jax_depth_shape.reconstruct3d_from_depth(rgb, depth, shift, focal)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_depth_shape_loads_the_reference_bundle(tmp_path):
    """--load_ckpt: a bundled .pth (depth_model, shift_model and
    focal_model under `module.`, the heads by torchsparse's names)
    replaces every random weight; it is read with weights_only."""
    cfg = DepthModelConfig(backbone="resnet50")
    src, _, _ = depth_shape_torch.build_models(cfg, None, "cpu")
    for p in src.parameters():
        p.data.mul_(0.5)
    heads = {k: _torchsparse_state_dict(np.random.default_rng(seed),
                                        list(tsp.CS), ch)
             for k, seed, ch in (("shift_model", 7, 3),
                                 ("focal_model", 8, CH))}
    path = str(tmp_path / "bundle.pth")
    torch.save(dict({"depth_model": {"module." + k: v for k, v in
                                     src.state_dict().items()}},
                    **{k: {"module." + n: torch.from_numpy(v)
                           for n, v in sd.items()}
                       for k, sd in heads.items()}), path)
    model, s, f = depth_shape_torch.build_models(cfg, path, "cpu")
    for k, v in src.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0,
                                       atol=0)
    for got, key in ((s, "shift_model"), (f, "focal_model")):
        jax.tree_util.tree_map(
            torch.testing.assert_close, got,
            tsp.convert_spvcnn_state_dict(heads[key], device="cpu"))


def test_depth_shape_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(depth_shape_torch.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        depth_shape_torch.main(["--img_dir", str(tmp_path)])
