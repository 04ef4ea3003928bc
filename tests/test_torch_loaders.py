"""The port's dataset loaders (google_nerf_tpu_torch/data/) against the
JAX package's on fixtures this file writes (the layouts of
tests/test_loaders.py and tests/test_data.py): nsvf (the Synthetic
family with RGBA frames resized on load, the Lego scale fix, trainval,
the Jade black-to-white fix, a BlendedMVS test trajectory), nerfpp,
rtmv (PNG frames; an EXR frame raises), colmap (the batched
quaternions, the 360_v2 images_{n} folder, test_traj), scannet (JPEG
frames resized from 1296x972 to the 640x480 grid, .npy and PNG depth
priors, rot_transpose, scale_flip, the raw-scan root search), and the
PFM/PLY/COLMAP parsers.

Tolerances: K, img_wh, splits, the PLY/PFM/COLMAP parsers exact;
directions 1e-7; poses 1e-6; rays 1e-6 from PNG frames and within the
decoder's bound (2/255) from JPEG frames; priors 1e-6; scene() tensors
equal to the numpy arrays."""
import json
import os
import struct

import numpy as np
import pytest
import torch

from google_nerf_tpu import data as jdata
from google_nerf_tpu.data import colmap_utils as jcu
from google_nerf_tpu.data import depth_utils as jdu
from google_nerf_tpu.data import loaders as jl
from google_nerf_tpu.data import ply as jply
from google_nerf_tpu_torch import data as tdata
from google_nerf_tpu_torch.data import colmap_utils as tcu
from google_nerf_tpu_torch.data import depth_utils as tdu
from google_nerf_tpu_torch.data import loaders as tl
from google_nerf_tpu_torch.data import ply as tply
from google_nerf_tpu_torch.utils.image import write_jpeg, write_png

JPEG_BOUND = 2 / 255


def _img(rng, hw, c=3):
    return rng.randint(0, 256, hw + (c,)).astype(np.uint8)


def _pose(t, rng=None):
    p = np.eye(4)
    if rng is not None:
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        p[:3, :3] = jcu.qvec2rotmat(q)
    p[:3, 3] = t
    return p


def same_dataset(got, want, rays_atol=1e-6):
    """Every array a loader sets, the port's against JAX's."""
    np.testing.assert_array_equal(got.K, want.K)
    assert tuple(got.img_wh) == tuple(want.img_wh)
    np.testing.assert_allclose(got.directions, np.asarray(want.directions),
                               atol=1e-7)
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-6)
    assert got.poses.dtype == np.float32
    assert got.rays.shape == want.rays.shape
    if want.rays.size:
        np.testing.assert_allclose(got.rays, want.rays, atol=rays_atol)
    if want.depths is None:
        assert got.depths is None
    else:
        np.testing.assert_allclose(got.depths, want.depths, atol=1e-6)
    for k in ("shift", "scale"):
        if hasattr(want, k):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                       rtol=1e-7)
    assert len(got) == len(want)
    s = got.scene(images_uint8=False)
    np.testing.assert_array_equal(s["images"].numpy(), got.rays)
    np.testing.assert_array_equal(s["poses"].numpy(), got.poses)
    np.testing.assert_array_equal(s["directions"].numpy(), got.directions)
    assert ("depths" in s) == (got.depths is not None)
    if got.depths is not None:
        np.testing.assert_array_equal(s["depths"].numpy(), got.depths)
    u8 = got.scene(images_uint8=True)["images"]
    assert u8.dtype == torch.uint8 and u8.device.type == "cpu"


def both(name, root, **kw):
    return (tdata.dataset_dict[name](root, device="cpu", **kw),
            jdata.dataset_dict[name](root, **kw))


# ------------------------------------------------------------- nsvf

def _nsvf(root, family="Synthetic_NeRF", scene="Lego", hw=(16, 16),
          rgba=True, black=False):
    root = os.path.join(root, family, scene)
    for d in ("rgb", "pose"):
        os.makedirs(os.path.join(root, d))
    rng = np.random.RandomState(0)
    np.savetxt(os.path.join(root, "bbox.txt"),
               np.array([[-1, -1.5, -1, 1, 1, 1.2, 0.01]]))
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        if family.startswith("Synthetic"):
            f.write("1111.0 400 400 0\n0 0 0\n")
        else:
            f.write("600 0 384 0\n0 600 288 0\n0 0 1 0\n0 0 0 1\n")
    for i, prefix in enumerate(["0_", "0_", "0_", "1_", "2_", "2_"]):
        img = _img(rng, hw, 4 if rgba else 3)
        if rgba:
            img[..., 3] = rng.choice([0, 128, 255], hw)
        if black:
            img[: hw[0] // 2] = 0
        write_png(os.path.join(root, "rgb", f"{prefix}{i:04d}.png"), img)
        np.savetxt(os.path.join(root, "pose", f"{prefix}{i:04d}.txt"),
                   _pose([0.1 * i, 0.2, 2 + i], rng))
    return root


@pytest.mark.parametrize("split", ["train", "test", "trainval"])
def test_nsvf_synthetic_matches_jax(tmp_path, split):
    root = _nsvf(str(tmp_path))          # 16x16 frames -> 8x8 on load
    got, want = both("nsvf", root, split=split, downsample=0.01)
    assert got.img_wh == (8, 8) and got.scale == pytest.approx(
        1.25 * 1.05 * 1.1)
    same_dataset(got, want)


def test_nsvf_black_to_white_and_test_traj_match_jax(tmp_path):
    root = _nsvf(str(tmp_path), scene="Jade_Synthetic", rgba=False,
                 black=True, hw=(8, 8))
    got, want = both("nsvf", root, split="train", downsample=0.01)
    same_dataset(got, want)
    assert (got.rays == 1.0).mean() > 0.4
    root = _nsvf(str(tmp_path), family="BlendedMVS", scene="Jade",
                 rgba=False, hw=(6, 8))
    rng = np.random.RandomState(1)
    np.savetxt(os.path.join(root, "test_traj.txt"),
               np.concatenate([_pose([0, 0, 3 + i], rng)
                               for i in range(4)]))
    got, want = both("nsvf", root, split="test_traj", downsample=0.01)
    assert len(got.poses) == 4
    same_dataset(got, want)


def test_nsvf_without_bbox_raises_as_jax(tmp_path):
    root = _nsvf(str(tmp_path))
    os.remove(os.path.join(root, "bbox.txt"))
    for ds in (tdata.dataset_dict["nsvf"], jdata.dataset_dict["nsvf"]):
        with pytest.raises(OSError):
            ds(root, split="train", downsample=0.01)


# ------------------------------------------------------------- nerfpp

def test_nerfpp_matches_jax(tmp_path):
    root = str(tmp_path)
    rng = np.random.RandomState(0)
    for d in ("train", "val", "test"):
        for sub in ("rgb", "pose", "intrinsics"):
            os.makedirs(os.path.join(root, d, sub))
        for i in range(3):
            write_png(os.path.join(root, d, "rgb", f"{i:05d}.png"),
                      _img(rng, (10, 12)))
            np.savetxt(os.path.join(root, d, "pose", f"{i:05d}.txt"),
                       _pose([0, 0, 3 + i], rng).reshape(1, -1))
            K = np.eye(4)
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 100.0, 90.0, 6.0, 5.0
            np.savetxt(os.path.join(root, d, "intrinsics", f"{i:05d}.txt"),
                       K.reshape(1, -1))
    for split, ds in (("train", 1.0), ("trainval", 0.5), ("test", 1.0)):
        got, want = both("nerfpp", root, split=split, downsample=ds)
        same_dataset(got, want)


# --------------------------------------------------------------- rtmv

def _rtmv(root, n=8, ext=".png"):
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.RandomState(0)
    for i in range(n):
        p = os.path.join(root, "images", f"{i:05d}{ext}")
        if ext == ".png":
            write_png(p, _img(rng, (8, 10)))
        else:
            with open(p, "wb") as f:
                f.write(b"\x76\x2f\x31\x01" + b"\0" * 64)
        cam = {"camera_data": {
            "cam2world": _pose([0.1, 0.2, 3 + i], rng).T.tolist(),
            "intrinsics": {"fx": 100.0, "fy": 100.0, "cx": 5.0, "cy": 4.0},
            "width": 10, "height": 8,
            "scene_center_3d_box": [0.1, 0, 0],
            "scene_min_3d_box": [-1, -1, -1],
            "scene_max_3d_box": [1, 1.5, 1]}}
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump(cam, f)
    return root


@pytest.mark.parametrize("scene", ["plain", "bricks"])
def test_rtmv_matches_jax(tmp_path, scene):
    root = _rtmv(str(tmp_path / scene))
    got, want = both("rtmv", root, split="all")
    same_dataset(got, want)


def test_rtmv_exr_frame_names_item_28(tmp_path):
    root = _rtmv(str(tmp_path / "s"), n=2, ext=".exr")
    with pytest.raises(NotImplementedError, match="item 28"):
        tdata.dataset_dict["rtmv"](root, split="all", device="cpu")


# ------------------------------------------------------------- colmap

def _colmap(root, n=10, folder="images", hw=(8, 10)):
    sparse = os.path.join(root, "sparse/0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, folder))
    rng = np.random.RandomState(0)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 20, 16))         # PINHOLE 20x16
        f.write(struct.pack("<dddd", 100.0, 90.0, 10.0, 8.0))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            name = f"im{(7 * i) % n:03d}.png"              # unsorted ids
            write_png(os.path.join(root, folder, name), _img(rng, hw))
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *(rng.randn(3) + [0, 0, -4])))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddqddq", 1.0, 2.0, 3, 4.0, 5.0, 5))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 20))
        for i in range(20):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *rng.normal(0, 0.5, 3)))
            f.write(struct.pack("<BBB", 100, 110, 120))
            f.write(struct.pack("<d", 0.1))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))
    return root


@pytest.mark.parametrize("split", ["train", "test", "test_traj"])
def test_colmap_matches_jax(tmp_path, split):
    root = _colmap(str(tmp_path / "scene"), hw=(16, 20))
    got, want = both("colmap", root, split=split, downsample=0.5)
    same_dataset(got, want)
    np.testing.assert_allclose(got.pts3d, want.pts3d, atol=1e-6)


def test_colmap_360_v2_reads_the_downsampled_folder(tmp_path):
    root = _colmap(str(tmp_path / "360_v2" / "garden"), folder="images_2")
    got, want = both("colmap", root, split="train", downsample=0.5)
    assert got.img_wh == (10, 8)
    same_dataset(got, want)


def test_colmap_parsers_and_quaternions_match_jax(tmp_path):
    from google_nerf_tpu.data.colmap import _quats_to_rotmats as jq
    from google_nerf_tpu_torch.data.colmap import _quats_to_rotmats as tq
    root = _colmap(str(tmp_path / "s"))
    sp = os.path.join(root, "sparse/0")
    for fn in ("read_cameras_binary", "read_images_binary",
               "read_points3d_binary"):
        name = {"read_cameras_binary": "cameras.bin",
                "read_images_binary": "images.bin",
                "read_points3d_binary": "points3D.bin"}[fn]
        got = getattr(tcu, fn)(os.path.join(sp, name))
        want = getattr(jcu, fn)(os.path.join(sp, name))
        assert sorted(got) == sorted(want)
        for k in want:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    q = np.random.RandomState(0).randn(16, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(tq(q), jq(q))
    for i in range(4):
        np.testing.assert_array_equal(tcu.qvec2rotmat(q[i]),
                                      jcu.qvec2rotmat(q[i]))
        np.testing.assert_array_equal(tcu.rotmat2qvec(jcu.qvec2rotmat(q[i])),
                                      jcu.rotmat2qvec(jcu.qvec2rotmat(q[i])))


def test_pfm_and_ply_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    for shape in ((6, 5), (4, 3, 3)):
        d = rng.rand(*shape).astype(np.float32)
        tdu.write_pfm(str(tmp_path / "t.pfm"), d)
        jdu.write_pfm(str(tmp_path / "j.pfm"), d)
        assert ((tmp_path / "t.pfm").read_bytes()
                == (tmp_path / "j.pfm").read_bytes())
        got, want = tdu.read_pfm(str(tmp_path / "t.pfm")), \
            jdu.read_pfm(str(tmp_path / "t.pfm"))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    xyz = rng.randn(50, 3).astype(np.float32)
    rgb = rng.randint(0, 255, (50, 3)).astype(np.uint8)
    tply.save_point_cloud(str(tmp_path / "t.ply"), xyz, rgb)
    jply.save_point_cloud(str(tmp_path / "j.ply"), xyz, rgb)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply"
                                                 ).read_bytes()
    np.testing.assert_array_equal(
        tply.read_ply_vertices(str(tmp_path / "t.ply")), xyz)
    with open(tmp_path / "a.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment x\nelement vertex 3\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nend_header\n")
        for v in xyz[:3]:
            f.write(" ".join(map(str, v)) + " 7\n")
    np.testing.assert_array_equal(
        tply.read_ply_vertices(str(tmp_path / "a.ply")),
        jply.read_ply_vertices(str(tmp_path / "a.ply")))


def test_shared_loaders_match_jax(tmp_path):
    x = np.linspace(0, 1, 101)
    np.testing.assert_array_equal(tl.srgb_to_linear(x), jl.srgb_to_linear(x))
    np.testing.assert_array_equal(tl.linear_to_srgb(x), jl.linear_to_srgb(x))
    got = tl.bbox_shift_scale([-1, -2, -3], [3, 2, 3])
    want = jl.bbox_shift_scale([-1, -2, -3], [3, 2, 3])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    poses = np.random.RandomState(0).rand(3, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(tl.normalize_c2w(poses, *got),
                                  jl.normalize_c2w(poses, *want))
    rng = np.random.RandomState(1)
    paths = []
    for i, c in enumerate((4, 3, 1)):          # RGBA, RGB, gray
        p = str(tmp_path / f"{i}.png")
        write_png(p, _img(rng, (9, 7), c)[..., :c] if c > 1
                  else _img(rng, (9, 7), 1)[..., 0])
        paths.append(p)
    for bg in (1.0, 0.0):
        np.testing.assert_allclose(
            tl.load_image_stack(paths, (5, 4), alpha_bg=bg),
            jl.load_image_stack(paths, (5, 4), alpha_bg=bg), atol=1e-6)


# ------------------------------------------------------------ scannet

def _scannet(root, n=4, layout="nested", priors="npy", hw=(972, 1296)):
    """A ScanNet scene: JPEG frames of hw, a 640x480 intrinsic_depth K,
    poses, the split files, the mesh PLY in the raw-scan `layout`
    ("nested": <raw>/<scene>/<scene>_vh_clean_2.ply; "flat":
    <raw>/<scene>_vh_clean_2.ply; "root": in the scene folder), and depth
    priors (.npy in m, "-depth_raw.png" / ".png" 16-bit in mm)."""
    scene = os.path.join(root, "processed", "scene0001_00")
    raw = os.path.join(root, "raw")
    for sub in ("rgb", "pose", "test_step_3"):
        os.makedirs(os.path.join(scene, sub))
    rng = np.random.RandomState(0)
    ply_dir = {"nested": os.path.join(raw, "scene0001_00"), "flat": raw,
               "root": scene}[layout]
    os.makedirs(ply_dir, exist_ok=True)
    tply.save_point_cloud(os.path.join(ply_dir,
                                       "scene0001_00_vh_clean_2.ply"),
                          rng.uniform([0, 1, 0], [4, 3, 2.5], (50, 3)))
    np.savetxt(os.path.join(scene, "intrinsic_depth.txt"),
               np.array([[577.87, 0, 319.5, 0], [0, 577.87, 239.5, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]]))
    depth_dir = os.path.join(root, "priors")
    os.makedirs(depth_dir)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    for i in range(n):
        np.savetxt(os.path.join(scene, "pose", f"{i}.txt"),
                   _pose([2 + 0.1 * i, 1.5, 1], rng))
        img = np.stack([np.sin(x / (9.0 + i)) * 100 + 120,
                        np.cos(y / 7.0) * 90 + 128, (x + 2 * y) % 256], -1)
        write_jpeg(os.path.join(scene, "rgb", f"{i}.jpg"),
                   np.clip(img, 0, 255).astype(np.uint8), quality=90)
        d_mm = rng.randint(500, 4000, (hw[0] // 2, hw[1] // 2))
        if priors == "npy":
            np.save(os.path.join(depth_dir, f"{i}.npy"),
                    (d_mm / 1000.0).astype(np.float32))
        else:
            suffix = "-depth_raw.png" if i % 2 else ".png"
            write_png(os.path.join(depth_dir, f"{i}{suffix}"),
                      d_mm.astype(np.uint16))
    with open(os.path.join(scene, "test_step_3", "train.txt"), "w") as f:
        f.write("0\n1\n3\n")
    with open(os.path.join(scene, "test_step_3", "test.txt"), "w") as f:
        f.write("2\n")
    return scene, raw, depth_dir


SCANNET_CASES = [
    pytest.param(dict(layout="nested", priors="npy"), {}, id="nested-npy"),
    pytest.param(dict(layout="flat", priors="png"),
                 dict(rot_transpose=True), id="flat-png-rot_transpose"),
    pytest.param(dict(layout="root", priors="png"),
                 dict(scale_flip=True), id="root-png-scale_flip"),
]


@pytest.mark.parametrize("fixture,kw", SCANNET_CASES)
def test_scannet_matches_jax(tmp_path, fixture, kw):
    scene, raw, depth_dir = _scannet(str(tmp_path), **fixture)
    for split in ("train", "test"):
        got, want = both("scannet", scene, split=split, downsample=0.1,
                         test_skip=3, raw_scan_rootdir=raw,
                         depth_dir=depth_dir, **kw)
        assert got.img_wh == (64, 48)
        same_dataset(got, want, rays_atol=JPEG_BOUND)
        assert got.depths.shape == (len(got.poses), 64 * 48)


def test_scannet_full_size_frames_match_jax(tmp_path):
    """640x480 from 1296x972 frames (the loader's default size)."""
    scene, raw, _ = _scannet(str(tmp_path))
    got, want = both("scannet", scene, split="train", test_skip=3,
                     raw_scan_rootdir=raw)
    assert got.img_wh == (640, 480)
    same_dataset(got, want, rays_atol=JPEG_BOUND)


def test_scannet_without_a_mesh_raises_as_jax(tmp_path):
    scene, _, _ = _scannet(str(tmp_path), n=1, layout="nested",
                           hw=(48, 64))
    for ds in (tdata.dataset_dict["scannet"],
               jdata.dataset_dict["scannet"]):
        with pytest.raises(FileNotFoundError, match="vh_clean_2"):
            ds(scene, split="train", test_skip=3,
               raw_scan_rootdir=str(tmp_path / "elsewhere"))
