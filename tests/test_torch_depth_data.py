"""The port's depth-training loader (google_nerf_tpu_torch/depth/data.py)
against JAX's (google_nerf_tpu/depth/data.py) on the CPU, on annotation
datasets the tests write with the port's PNG encoder (8-bit RGB frames,
16-bit depth with invalid zeros), which JAX reads through cv2:

  * tests/test_depth_trainer.py::test_multi_dataset_sampler_interleaves
    on the port;
  * the raw read (the PNG path) exactly JAX's;
  * get_val and get_train from one default_rng seed: depth, disp,
    planes, focal_length and quality_flg exactly JAX's (nearest resizes
    and crops copy values), rgb within 1e-5 (cv2's float32 bilinear
    taps against the port's, seen in tests/test_torch_image.py within
    1.6e-6 before the ImageNet scaling);
  * the sampler's indices and batches over three epochs, two datasets of
    different lengths and two ranks: indices exactly equal, batches as
    the items."""
import dataclasses
import json
import os

import numpy as np
import pytest

from google_nerf_tpu.depth import data as jdata
from google_nerf_tpu.depth.config import DepthCfg as JDepthCfg
from google_nerf_tpu_torch.depth import data as tdata
from google_nerf_tpu_torch.depth.config import DepthCfg
from google_nerf_tpu_torch.utils.image import write_png


def write_dataset(root, name="demo", n=6, hw=(40, 52), seed=0,
                  split="train"):
    """n frames: a smooth RGB scene with noise and a 16-bit depth in mm
    with a few invalid (zero) pixels, and the annotation JSON."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, name)
    for d in ("rgb", "depth", "annotations"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    annos = []
    for i in range(n):
        depth = (1.0 + xx + 0.5 * yy + 0.1 * rng.random()) * 1000
        depth[rng.random((h, w)) < 0.02] = 0
        rgb = np.stack([xx, yy, 1 - xx], -1) * 200 + rng.normal(
            0, 12, (h, w, 3))
        write_png(f"{base}/rgb/{i:04d}.png",
                  np.clip(rgb, 0, 255).astype(np.uint8))
        write_png(f"{base}/depth/{i:04d}.png", depth.astype(np.uint16))
        annos.append({"rgb_path": f"{name}/rgb/{i:04d}.png",
                      "depth_path": f"{name}/depth/{i:04d}.png"})
    with open(os.path.join(base, "annotations",
                           f"{split}_annotations.json"), "w") as f:
        json.dump(annos, f)
    return root


def _cfgs(crop):
    return (dataclasses.replace(DepthCfg().dataset, crop_size=crop),
            dataclasses.replace(JDepthCfg().dataset, crop_size=crop))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("depth_data"))
    write_dataset(root, "demo", n=6)
    write_dataset(root, "taskonomy_small", n=4, hw=(30, 24), seed=1)
    return root


def _same_item(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k == "rgb":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_multi_dataset_sampler_interleaves(tmp_path):
    root = str(tmp_path)
    write_dataset(root, n=4, hw=(16, 16))
    cfg = _cfgs((16, 16))[0]
    ds = tdata.DepthAnnotationDataset(root, "demo", cfg=cfg)
    ds2 = tdata.DepthAnnotationDataset(root, "demo", cfg=cfg)
    s = tdata.MultiDatasetSampler([ds, ds2])
    idxs = s.epoch_indices(0)
    assert [i[0] for i in idxs[:4]] == [0, 1, 0, 1]
    s0 = tdata.MultiDatasetSampler([ds, ds2], rank=0, world_size=2)
    s1 = tdata.MultiDatasetSampler([ds, ds2], rank=1, world_size=2)
    a, b = s0.epoch_indices(0), s1.epoch_indices(0)
    assert len(a) == len(b) == len(idxs) // 2
    assert a + b != idxs
    assert sorted(a + b) == sorted(idxs)
    batch = next(iter(s.batches(0, 2)))
    assert batch["rgb"].shape == (2, 16, 16, 3)
    assert batch["depth"].shape == (2, 16, 16)
    assert batch["quality_flg"].shape == (2,)


@pytest.mark.parametrize("name", ["demo", "taskonomy_small"])
def test_items_match_jax(root, name):
    tcfg, jcfg = _cfgs((32, 32))
    tds = tdata.DepthAnnotationDataset(root, name, cfg=tcfg)
    jds = jdata.DepthAnnotationDataset(root, name, cfg=jcfg)
    assert (tds.quality_flg, tds.focal_length) == (jds.quality_flg,
                                                   jds.focal_length)
    for i in range(len(jds)):
        for got, want in zip(tds._load_raw(i), jds._load_raw(i)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        _same_item(tds.get_val(i), jds.get_val(i))
    trng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):                       # several draws of each item
        for i in range(len(jds)):
            _same_item(tds.get_train(i, trng), jds.get_train(i, jrng))


def test_sampler_matches_jax(root):
    tcfg, jcfg = _cfgs((24, 24))
    t = [tdata.DepthAnnotationDataset(root, n, cfg=tcfg)
         for n in ("demo", "taskonomy_small")]
    j = [jdata.DepthAnnotationDataset(root, n, cfg=jcfg)
         for n in ("demo", "taskonomy_small")]
    for rank in (0, 1):
        ts = tdata.MultiDatasetSampler(t, rank=rank, world_size=2, seed=3)
        js = jdata.MultiDatasetSampler(j, rank=rank, world_size=2, seed=3)
        assert len(ts) == len(js)
        for epoch in range(3):
            assert ts.epoch_indices(epoch) == js.epoch_indices(epoch)
            for train in (True, False):
                tb = list(ts.batches(epoch, 2, train=train))
                jb = list(js.batches(epoch, 2, train=train))
                assert len(tb) == len(jb) > 0
                for got, want in zip(tb, jb):
                    _same_item(got, want)
