"""The port's scannet_tools (.sens -> export -> split) against JAX's on
the .sens files the tests write, and the ScanNet chain
(tests/test_scannet_chain_e2e.py) on the port: .sens -> process_scene ->
ScannetDataset -> depth-supervised training steps.

Tolerances: the .sens bytes, headers, frames, depth arrays, the zlib
output, the pose and intrinsic .txt files, the exported depth PNGs
(decoded) and the splits are equal.  Colour: the port decodes a frame's
JPEG within its codec's bound against Pillow (tests/test_torch_image.py:
max abs 2, mean 0.1); the exporters write JPEGs at imageio's quality,
Pillow's default 75, with the same quantisation tables as JAX's; the
port's exported JPEG decodes within that bound of what Pillow decodes
from it; its PSNR against the pixels JAX encoded lies within 1 dB of
JAX's exported JPEG's (another encoder of the same pixels at the same
quality: 0.03-0.74 dB apart on these frames, whose nearest-resized
noise quantises coarsely).  The chain's priors are in scene units at
rtol 1e-5, as JAX's test holds them."""
import io
import os
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from google_nerf_tpu.data.scannet import ScannetDataset as JaxScannet
from google_nerf_tpu.scannet_tools import native as jax_native
from google_nerf_tpu.scannet_tools import process as jax_process
from google_nerf_tpu.scannet_tools import sensor_data as jax_sd
from google_nerf_tpu_torch.data.ply import save_point_cloud
from google_nerf_tpu_torch.data.scannet import ScannetDataset
from google_nerf_tpu_torch.ops.cuda import _build
from google_nerf_tpu_torch.scannet_tools import native, process
from google_nerf_tpu_torch.scannet_tools import sensor_data as sd
from google_nerf_tpu_torch.utils.image import read_image

COLOR_WH, DEPTH_WH = (32, 24), (16, 12)


def _jpeg(rgb):
    buf = io.BytesIO()
    imageio.imwrite(buf, rgb, format="jpeg")
    return buf.getvalue()


def _frames(n=5, color_wh=COLOR_WH, depth_wh=DEPTH_WH, seed=0):
    """n frames: a smooth textured colour image (imageio's JPEG), random
    depth in mm, the camera moved along x by the frame's index."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:color_wh[1], 0:color_wh[0]]
    frames = []
    for i in range(n):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [i, 0.25 * i, 0]
        rgb = np.stack([np.sin(xx / (3 + i)) * 90 + 120,
                        np.cos(yy / (4 + i)) * 80 + 110,
                        (xx * 5 + yy * (i + 3)) % 200 + 20], -1)
        rgb = np.clip(rgb + rng.normal(0, 6, rgb.shape), 0, 255)
        depth = (rng.rand(depth_wh[1], depth_wh[0]) * 5000).astype(np.uint16)
        frames.append((c2w, _jpeg(rgb.astype(np.uint8)), depth))
    return frames


K_COLOR = np.array([[40.0, 0, 16, 0], [0, 40.0, 12, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
K_DEPTH = np.array([[20.0, 0, 8, 0], [0, 20.0, 6, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)


def _write(module, path, frames):
    module.write_sens(path, frames=frames, color_wh=COLOR_WH,
                      depth_wh=DEPTH_WH, intrinsic_color=K_COLOR,
                      intrinsic_depth=K_DEPTH)
    return path


@pytest.fixture()
def sens_file(tmp_path):
    frames = _frames()
    return _write(sd, str(tmp_path / "scene0000_00.sens"), frames), frames


def test_write_sens_writes_jax_bytes(tmp_path):
    frames = _frames()
    a = _write(sd, str(tmp_path / "port.sens"), frames)
    b = _write(jax_sd, str(tmp_path / "jax.sens"), frames)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_sens_header_and_frames_match_jax(sens_file):
    path, frames = sens_file
    ours, theirs = sd.SensorData(path), jax_sd.SensorData(path)
    try:
        for k in ("sensor_name", "color_compression_type",
                  "depth_compression_type", "color_width", "color_height",
                  "depth_width", "depth_height", "depth_shift",
                  "num_frames"):
            assert getattr(ours, k) == getattr(theirs, k), k
        for k in ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
                  "extrinsic_depth"):
            np.testing.assert_array_equal(getattr(ours, k),
                                          getattr(theirs, k))
        assert ours.num_frames == 5 and ours.depth_shift == 1000.0
        assert len(ours.frames) == 5
        for i, (f, g) in enumerate(zip(ours.iter_frames(),
                                       theirs.iter_frames())):
            np.testing.assert_array_equal(f.camera_to_world,
                                          g.camera_to_world)
            assert (f.timestamp_color, f.timestamp_depth, f.color_data,
                    f.depth_data) == (g.timestamp_color, g.timestamp_depth,
                                      g.color_data, g.depth_data)
            d = f.depth_image(ours.depth_compression_type,
                              ours.depth_height, ours.depth_width)
            np.testing.assert_array_equal(d, frames[i][2])
        f3 = ours.frame(3)          # lazy random access
        np.testing.assert_allclose(f3.camera_to_world[:3, 3],
                                   [3, 0.75, 0])
        np.testing.assert_array_equal(
            f3.depth_image(ours.depth_compression_type, 12, 16),
            frames[3][2])
        with pytest.raises(ValueError, match="invalid depth"):
            f3.decompress_depth("raw_ushort")
    finally:
        ours.close()
        theirs.close()


def test_color_decodes_as_pillow(sens_file):
    """A frame's JPEG through the port's decoder against imageio
    (Pillow), JAX's decompress_color."""
    path, _ = sens_file
    ours, theirs = sd.SensorData(path), jax_sd.SensorData(path)
    try:
        for f, g in zip(ours.iter_frames(), theirs.iter_frames()):
            a = f.decompress_color("jpeg").astype(int)
            b = np.asarray(g.decompress_color("jpeg")).astype(int)
            diff = np.abs(a - b)
            assert diff.max() <= 2 and diff.mean() <= 0.1
    finally:
        ours.close()
        theirs.close()


def test_native_zlib_matches_python_and_jax():
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 255, 4096).astype(np.uint8).tobytes()
    comp = zlib.compress(raw)
    assert native.zlib_decompress(comp) == raw
    assert native.zlib_decompress(comp) == jax_native.zlib_decompress(comp)
    # past the helper's buffer: Python's zlib decompresses it, as in JAX
    assert native.zlib_decompress(comp, max_size=1000) == raw
    out = native.zlib_decompress_batch([comp] * 7, len(raw), n_threads=3)
    assert out.shape == (7, 4096)
    for i in range(7):
        assert out[i].tobytes() == raw
    depths = [rng.randint(0, 5000, (12, 16)).astype(np.uint16)
              for _ in range(9)]
    bulk = native.zlib_decompress_batch(
        [zlib.compress(d.tobytes()) for d in depths], 12 * 16 * 2)
    for d, b in zip(depths, bulk):
        np.testing.assert_array_equal(b.view(np.uint16).reshape(12, 16), d)


def test_native_corrupt_streams_raise():
    comp = zlib.compress(b"\x07" * 4096)
    with pytest.raises(zlib.error):
        native.zlib_decompress(b"not a zlib stream")
    with pytest.raises(ValueError, match="1 buffers failed"):
        native.zlib_decompress_batch([comp, comp[:20]], 4096)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="sens_decode"):
        _build.build("sens_decode")
    assert _build.library_path("sens_decode").suffix == ".so"


def _dqt(path):
    """The JPEG's quantisation tables (its DQT segments)."""
    data, pos, out = open(path, "rb").read(), 2, []
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDB:
            out.append(data[pos + 4:pos + 2 + n])
        if marker == 0xDA:
            break
        pos += 2 + n
    return out


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("image_size", [(12, 16), (6, 8)],
                         ids=["depth_native", "both_resized"])
def test_process_scene_and_split_match_jax(sens_file, tmp_path,
                                           image_size):
    import cv2
    from PIL import Image
    path, frames = sens_file
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    process.process_scene(path, ours, frame_skip=2, image_size=image_size)
    jax_process.process_scene(path, theirs, frame_skip=2,
                              image_size=image_size)
    assert _tree(ours) == _tree(theirs)
    assert sorted(os.listdir(os.path.join(ours, "rgb"))) == \
        ["0.jpg", "2.jpg", "4.jpg"]
    for name in ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
                 "extrinsic_depth"):
        a = open(os.path.join(ours, name + ".txt"), "rb").read()
        assert a == open(os.path.join(theirs, name + ".txt"), "rb").read()
    for i in (0, 2, 4):
        a = open(os.path.join(ours, "pose", f"{i}.txt"), "rb").read()
        assert a == open(os.path.join(theirs, "pose", f"{i}.txt"),
                         "rb").read()
        d_ours = read_image(os.path.join(ours, "depth", f"{i}.png"))
        d_theirs = np.asarray(imageio.imread(
            os.path.join(theirs, "depth", f"{i}.png")))
        assert d_ours.dtype == np.uint16 and d_ours.shape == image_size
        np.testing.assert_array_equal(d_ours, d_theirs)
        np.testing.assert_array_equal(np.asarray(imageio.imread(
            os.path.join(ours, "depth", f"{i}.png"))), d_theirs)
        if image_size == (12, 16):
            np.testing.assert_array_equal(d_ours, frames[i][2])
        jpg_ours = os.path.join(ours, "rgb", f"{i}.jpg")
        jpg_theirs = os.path.join(theirs, "rgb", f"{i}.jpg")
        assert _dqt(jpg_ours) == _dqt(jpg_theirs)
        mine = read_image(jpg_ours).astype(int)
        pil = np.asarray(Image.open(jpg_ours)).astype(int)
        assert mine.shape == image_size + (3,)
        assert np.abs(mine - pil).max() <= 2
        assert np.abs(mine - pil).mean() <= 0.1
        # both exports against the pixels JAX encoded (Pillow's decode,
        # cv2's nearest resize): the same loss of quality, within 1 dB
        src = frames[i][1]
        pre = cv2.resize(np.asarray(Image.open(io.BytesIO(src))),
                         image_size[::-1], interpolation=cv2.INTER_NEAREST)
        jax_db = _psnr(np.asarray(Image.open(jpg_theirs)), pre)
        assert abs(_psnr(pil, pre) - jax_db) <= 1.0, (_psnr(pil, pre), jax_db)
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(ours, "pose", "4.txt"))[:3, 3], [4, 1, 0])
    assert process.split_train_test(ours, test_step=2) == \
        jax_process.split_train_test(theirs, test_step=2) == ([2], [0, 4])
    for name in ("train", "test"):
        assert open(os.path.join(ours, "test_step_2", name + ".txt")).read() \
            == open(os.path.join(theirs, "test_step_2",
                                 name + ".txt")).read()


def test_process_cli_scene_batch_split_match_jax(tmp_path):
    """`python -m google_nerf_tpu_torch.scannet_tools.process` scene,
    batch and split against JAX's main, in process."""
    scans = tmp_path / "scans"
    for k, name in enumerate(("scene0000_00", "scene0001_00")):
        os.makedirs(scans / name)
        _write(sd, str(scans / name / f"{name}.sens"),
               _frames(n=4 + k, seed=k))
    sens = str(scans / "scene0000_00" / "scene0000_00.sens")
    for label, main in (("port", process.main), ("jax", jax_process.main)):
        out = str(tmp_path / label)
        main(["scene", "--filename", sens, "--output_path",
              os.path.join(out, "one"), "--frame_skip", "1", "--height",
              "12", "--width", "16", "--test_step", "3"])
        main(["split", "--output_path", os.path.join(out, "one"),
              "--test_step", "2"])
        main(["batch", "--scans_root", str(scans), "--output_root",
              os.path.join(out, "all"), "--frame_skip", "2",
              "--test_step", "2"])
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _tree(ours) == _tree(theirs)
    for rel in _tree(ours):
        if rel.endswith(".txt"):
            assert open(os.path.join(ours, rel)).read() == \
                open(os.path.join(theirs, rel)).read(), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(
                read_image(os.path.join(ours, rel)),
                np.asarray(imageio.imread(os.path.join(theirs, rel))))
    with open(os.path.join(ours, "all", "scene0001_00", "test_step_2",
                           "test.txt")) as f:
        assert f.read().split() == ["0", "4"]


def test_module_runs_as_a_script(tmp_path, sens_file):
    import subprocess
    import sys
    path, _ = sens_file
    out = str(tmp_path / "cli")
    subprocess.run([sys.executable, "-m",
                    "google_nerf_tpu_torch.scannet_tools.process", "scene",
                    "--filename", path, "--output_path", out,
                    "--frame_skip", "2", "--height", "12", "--width", "16",
                    "--test_step", "2"], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
    assert sorted(os.listdir(os.path.join(out, "depth"))) == \
        ["0.png", "2.png", "4.png"]
    with open(os.path.join(out, "test_step_2", "train.txt")) as f:
        assert f.read().split() == ["2"]


def test_label_helpers_match_jax(tmp_path):
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tnyu40id\n1\twall\t1\n2\tchair\t5\n"
                   "3\tfloor\t2\n")
    ours = process.read_label_mapping(str(tsv), "id", "nyu40id")
    assert ours == jax_process.read_label_mapping(str(tsv), "id", "nyu40id")
    assert ours == {1: 1, 2: 5, 3: 2}
    named = process.read_label_mapping(str(tsv))
    assert named == {"wall": 1, "chair": 5, "floor": 2}
    img = np.random.default_rng(0).integers(0, 5, (6, 7))
    got = process.map_label_image(img, ours)
    np.testing.assert_array_equal(got, jax_process.map_label_image(img,
                                                                   ours))
    assert got.dtype == np.uint16
    assert process.scene_scale("scene0079_00") == 6.31
    assert process.scene_scale("scene9999_00", 2.0) == 2.0


def test_scannet_chain_sens_to_depth_supervised_training(tmp_path):
    """tests/test_scannet_chain_e2e.py on the port: a .sens of six
    cameras on an arc -> process_scene -> split_train_test ->
    ScannetDataset with per-frame priors (held against JAX's dataset on
    the same tree) and with the exported depth PNGs as priors -> ten
    depth-supervised training steps."""
    from google_nerf_tpu_torch.models.ngp import NGPConfig
    from google_nerf_tpu_torch.train.system import (TrainConfig,
                                                    init_train_state,
                                                    run_training)
    rng = np.random.RandomState(0)
    h_img, w_img = 12, 16
    K = np.array([[16.0, 0, 8.0, 0], [0, 16.0, 6.0, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    frames = []
    for i in range(6):
        th = (i - 2.5) * 0.15
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [np.sin(th) * 1.2, 0.0, -np.cos(th) * 1.2]
        rgb = rng.randint(0, 255, (h_img, w_img, 3)).astype(np.uint8)
        depth = np.full((h_img, w_img), 1200, np.uint16)       # 1.2 m
        frames.append((c2w, _jpeg(rgb), depth))
    sens = str(tmp_path / "scene0000_00.sens")
    sd.write_sens(sens, intrinsic_depth=K, color_wh=(w_img, h_img),
                  depth_wh=(w_img, h_img), frames=frames)

    out = str(tmp_path / "scene0000_00")
    process.process_scene(sens, out, frame_skip=1, image_size=(h_img, w_img))
    train_ids, test_ids = process.split_train_test(out, test_step=3)
    assert train_ids == [1, 2, 4, 5] and test_ids == [0, 3]
    verts = rng.uniform(-1.4, 1.4, (200, 3)).astype(np.float32)
    save_point_cloud(os.path.join(out, "scene0000_00_vh_clean_2.ply"),
                     verts)
    prior_dir = str(tmp_path / "priors")
    os.makedirs(prior_dir)
    for i in train_ids + test_ids:
        np.save(os.path.join(prior_dir, f"{i}.npy"),
                np.full((h_img, w_img), 1.1, np.float32))

    kw = dict(split="train", downsample=w_img / 640.0, test_skip=3,
              raw_scan_rootdir=str(tmp_path))
    ds = ScannetDataset(out, depth_dir=prior_dir, device="cpu", **kw)
    jds = JaxScannet(out, depth_dir=prior_dir, **kw)
    assert ds.img_wh == jds.img_wh == (w_img, h_img)
    assert ds.rays.shape[0] == len(train_ids)
    np.testing.assert_allclose(np.asarray(ds.poses), np.asarray(jds.poses),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ds.rays), np.asarray(jds.rays),
                               atol=1e-6)
    assert ds.depths is not None and ds.depths.shape == ds.rays.shape[:2]
    np.testing.assert_allclose(np.asarray(ds.depths), 1.1 / (2 * ds.scale),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ds.depths), np.asarray(jds.depths),
                               rtol=1e-6)
    assert np.abs(np.asarray(ds.poses)[:, :, 3]).max() <= 0.5 + 1e-5

    # the exported depth PNGs (mm) as the priors
    png = ScannetDataset(out, depth_dir=os.path.join(out, "depth"),
                         device="cpu", **kw)
    np.testing.assert_allclose(np.asarray(png.depths),
                               1.2 / (2 * png.scale), rtol=1e-5)

    scene = ds.scene()
    assert "depths" in scene
    model = NGPConfig(scale=0.5, encoder="packed", packed_levels=4,
                      packed_log2_size=12, grid_size=32)
    cfg = TrainConfig(model=model, batch_size=256, k_samples=16,
                      max_samples=64, lr=1e-2, num_epochs=1,
                      steps_per_epoch=10, warmup_steps=4, lambda_depth=0.5)
    state = init_train_state(cfg, ds.K, ds.poses, ds.img_wh, device="cpu")
    state, metrics = run_training(state, scene, cfg, steps=10,
                                  generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["psnr"]))
    assert int(state["step"]) == 10
