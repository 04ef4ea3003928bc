"""Every JPEG coding mode that JAX's reader (imageio.v2.imread: Pillow on
libjpeg-turbo) decodes, through the port's reader (utils/image.read_image,
csrc/image_codec.c), on files that google_nerf_tpu_torch/tools/
jpeg_fixture.py writes (small frames, odd sizes included).  Every case is
held against imageio on the same file bit for bit:

  * 4:4:0 chroma (luma 1x2, chroma 1x1: h1v2 fancy upsampling), baseline
    and progressive, and the other factor sets that reach it;
  * three components under the JFIF / Adobe / component-id colour rule
    (jdapimin.c default_decompress_parms): JFIF means YCbCr, then an
    Adobe transform, then the ids;
  * four components: Pillow's own CMYK files, the writer's CMYK with and
    without an Adobe marker, and YCCK (Adobe transform 2 or 1);
    imageio's (H, W, 4) samples are Pillow's inverted CMYK; through the
    loaders' decode_image the port equals JAX's (float32, equal);
  * arithmetic coding: SOF9 with and without DAC conditioning and
    restart intervals, SOF10 with libjpeg's simple progression (all four
    scan kinds); each also equals its Huffman twin (the same quantised
    coefficients, so the same samples);
  * lossless SOF3: predictors 1-7 at every point transform 0-7, gray
    and RGB, restarts, subsampled (replicated, not fancy) and CMYK; at
    Pt 0 equal to the pixels written;
  * the modes both readers refuse: lossless in YCbCr or YCCK (no colour
    conversion in lossless mode) and a lossless restart interval that is
    not whole MCU rows;
  * a COLMAP scene of mixed-mode frames through both loaders (rays
    1e-6).
"""
import io
import itertools
import os

import numpy as np
import pytest

from google_nerf_tpu.data import loaders as jl
from google_nerf_tpu_torch.data import loaders as tl
from google_nerf_tpu_torch.tools.colmap_fixture import write_model
from google_nerf_tpu_torch.tools.jpeg_fixture import Frame, encode, write_jpeg
from google_nerf_tpu_torch.utils import image as im
from test_torch_loaders import both, same_dataset

imageio = pytest.importorskip("imageio.v2")
Image = pytest.importorskip("PIL.Image")


def _scene(h, w, c=3, seed=0):
    """Smooth ramps, a checker and noise: JPEG-like content."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 128,
                    (x * 3 + y * 2) % 256, (x * 5 + y) % 256][:c], -1)
    img[(x // 9 + y // 9) % 2 == 0] *= 0.6
    img += np.random.RandomState(seed).randn(h, w, c) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _as_imageio(tmp_path, data, name="f.jpg"):
    """The file's samples by the port's read_image, asserted equal to
    imageio's bit for bit; returns them."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = imageio.imread(path)
    got = im.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


SIZES = [(64, 48), (21, 47), (47, 61), (9, 17)]
S420 = [(2, 2), (1, 1), (1, 1)]


# ------------------------------------------------------------ F6: 4:4:0

F6 = [(hw, p, q) for hw in SIZES for p in (False, True) for q in (75, 95)]


@pytest.mark.parametrize("hw,progressive,quality", F6,
                         ids=[f"{h}x{w}-{'prog' if p else 'base'}-q{q}"
                              for (h, w), p, q in F6])
def test_440_decodes_as_imageio(tmp_path, hw, progressive, quality):
    data = write_jpeg(None, _scene(*hw), quality=quality,
                      sampling=[(1, 2), (1, 1), (1, 1)],
                      progressive=progressive)
    assert (b"\xff\xc2" if progressive else b"\xff\xc0") in data
    _as_imageio(tmp_path, data)


FACTORS = [[(2, 2), (2, 1), (1, 2)], [(1, 4), (1, 2), (1, 1)],
           [(2, 4), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
           [(1, 2), (1, 2), (1, 1)]]


@pytest.mark.parametrize("sampling", FACTORS,
                         ids=["-".join(f"{h}{v}" for h, v in s)
                              for s in FACTORS])
def test_other_factor_sets_decode_as_imageio(tmp_path, sampling):
    """1h2v components beside 2h1v ones and beside 1h4v (replicated)
    luma, 2h4v and 4h1v (replicated), and a 1x2 chroma plane beside a 1x1
    one."""
    for hw in SIZES:
        _as_imageio(tmp_path, write_jpeg(None, _scene(*hw),
                                         sampling=sampling))


def test_an_mcu_of_more_than_ten_blocks_is_refused(tmp_path):
    """libjpeg takes at most 10 blocks an interleaved MCU: 2x4 + 2x2 +
    1x1 is 13; both readers refuse it."""
    path = tmp_path / "f.jpg"
    write_jpeg(str(path), _scene(21, 47),
               sampling=[(2, 4), (2, 2), (1, 1)])
    with pytest.raises(Exception):
        imageio.imread(str(path))
    with pytest.raises(ValueError, match="f.jpg: .*more than 10 blocks"):
        im.read_image(str(path))


# ---------------------------------------- F7: the three-component rule

F7 = [(jfif, adobe, ids, first)
      for jfif, adobe, ids in itertools.product(
          (False, True), (None, 0, 1, 2), ((1, 2, 3), (82, 71, 66),
                                           (0, 1, 2)))
      for first in ((False,) if adobe is None else (False, True))]


@pytest.mark.parametrize(
    "jfif,adobe,ids,first", F7,
    ids=[f"{'jfif' if j else 'nojfif'}-adobe{a}-ids{''.join(map(str, i))}"
         f"{'-adobe_first' if f else ''}" for j, a, i, f in F7])
def test_colour_rule_decodes_as_imageio(tmp_path, jfif, adobe, ids, first):
    """YCbCr-coded samples under every marker set: JFIF wins over Adobe
    (before or after the APP0), Adobe over the ids."""
    _as_imageio(tmp_path, write_jpeg(None, _scene(23, 29), quality=90,
                                     jfif=jfif, adobe=adobe, ids=ids,
                                     adobe_first=first))


def test_rgb_stored_frames_decode_as_imageio(tmp_path):
    """Samples stored as R, G, B: read back as stored where the rule says
    RGB (Adobe 0 without JFIF; ids 'R', 'G', 'B' without markers)."""
    img = _scene(23, 29)
    for kw in (dict(adobe=0), dict(ids=(82, 71, 66))):
        data = write_jpeg(None, img, quality=100, colour="rgb", jfif=False,
                          **kw)
        got = _as_imageio(tmp_path, data)
        assert np.abs(got.astype(int) - img).mean() < 2.0


def test_a_short_jfif_segment_is_not_jfif(tmp_path):
    """jdmarker.c examine_app0 takes a JFIF APP0 of 14 bytes or more: a
    12-byte one (the shortest Pillow parses) leaves the Adobe transform
    0 in charge (RGB)."""
    img = _scene(16, 24)
    data = write_jpeg(None, img, quality=100, colour="rgb", jfif=False,
                      adobe=0)
    short = b"\xff\xe0\x00\x0eJFIF\x00\x01\x01\x00\x00\x01\x00\x01"
    got = _as_imageio(tmp_path, data[:2] + short + data[2:])
    assert np.abs(got.astype(int) - img).mean() < 2.0


# ------------------------------------------------------ four components

@pytest.mark.parametrize("quality", [75, 95])
def test_pillow_cmyk_decodes_as_imageio(tmp_path, quality):
    buf = io.BytesIO()
    Image.fromarray(_scene(47, 61, 4), "CMYK").save(buf, "JPEG",
                                                   quality=quality)
    got = _as_imageio(tmp_path, buf.getvalue())
    assert got.shape == (47, 61, 4)


CMYK = [(colour, adobe, coding) for colour, adobe in
        (("cmyk", None), ("cmyk", 0), ("ycck", 2), ("ycck", 1))
        for coding in ("huffman", "arithmetic")]


@pytest.mark.parametrize("colour,adobe,coding", CMYK,
                         ids=[f"{c}-adobe{a}-{k}" for c, a, k in CMYK])
def test_four_components_decode_as_imageio(tmp_path, colour, adobe,
                                           coding):
    """No Adobe marker or transform 0: CMYK as stored; transform 2 (and
    1, which libjpeg also takes as YCCK): YCCK converted; both inverted
    as Pillow reads them.  K subsampled like luma."""
    c4 = _scene(21, 47, 4)
    data = write_jpeg(None, c4, quality=95, colour=colour, adobe=adobe,
                      jfif=False, coding=coding,
                      sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])
    got = _as_imageio(tmp_path, data)
    # C, M, Y, K in order: near the samples written (the sawtooth
    # channels lose detail to the 2x2 subsampling of three of them)
    assert np.abs((255 - got).astype(int) - c4).mean() < 8.0


def test_cmyk_through_decode_image_equals_jax(tmp_path):
    """JAX's decode_image composites the fourth channel as alpha; the
    port's does the same, equal in float32, resized or not."""
    path = str(tmp_path / "c.jpg")
    write_jpeg(path, _scene(24, 32, 4), colour="ycck", adobe=2, jfif=False)
    for wh in ((32, 24), (16, 12)):
        np.testing.assert_array_equal(tl.decode_image(path, wh),
                                      jl.decode_image(path, wh))


# ------------------------------------------------------------ arithmetic

ARITH = [(hw, dac, rst) for hw in SIZES for dac in (None, (1, 4, 10))
         for rst in (0, 3)]


@pytest.mark.parametrize("hw,dac,restart", ARITH,
                         ids=[f"{h}x{w}-{'dac' if d else 'nodac'}-rst{r}"
                              for (h, w), d, r in ARITH])
def test_sof9_decodes_as_imageio_and_its_twin(tmp_path, hw, dac, restart):
    frame = Frame(_scene(*hw), 90, S420)
    data = encode(frame, coding="arithmetic", dac=dac, restart=restart)
    assert b"\xff\xc9" in data and (b"\xff\xcc" in data) == bool(dac)
    got = _as_imageio(tmp_path, data)
    np.testing.assert_array_equal(got, im.decode_jpeg(encode(frame)))


PROG = [(hw, dac, rst) for hw in SIZES for dac in (None, (0, 2, 3))
        for rst in (0, 2)]


@pytest.mark.parametrize("hw,dac,restart", PROG,
                         ids=[f"{h}x{w}-{'dac' if d else 'nodac'}-rst{r}"
                              for (h, w), d, r in PROG])
def test_sof10_decodes_as_imageio_and_its_twin(tmp_path, hw, dac, restart):
    """libjpeg's simple progression: DC first and refinement (interleaved),
    AC first bands at Al 2 and 1, AC refinements."""
    frame = Frame(_scene(*hw), 90, S420)
    data = encode(frame, coding="arithmetic", progressive=True, dac=dac,
                  restart=restart)
    assert b"\xff\xca" in data and data.count(b"\xff\xda") == 10
    got = _as_imageio(tmp_path, data)
    np.testing.assert_array_equal(got, im.decode_jpeg(encode(frame)))


def test_arithmetic_gray_and_440_and_high_quality(tmp_path):
    """Gray frames, 4:4:0 and quality 100 (large magnitudes, the Kx
    split), sequential and progressive, each equal to its twin."""
    for img, sampling in ((_scene(33, 45)[..., 0], None),
                          (_scene(33, 45), [(1, 2), (1, 1), (1, 1)]),
                          (_scene(64, 64, seed=3), None)):
        for q in (50, 100):
            frame = Frame(img, q, sampling)
            twin = im.decode_jpeg(encode(frame))
            for prog in (False, True):
                got = _as_imageio(tmp_path, encode(
                    frame, coding="arithmetic", progressive=prog))
                np.testing.assert_array_equal(got, twin)


# -------------------------------------------------------------- lossless

LOSSLESS = [(p, pt) for p in range(1, 8) for pt in range(8)]


@pytest.mark.parametrize("predictor,pt", LOSSLESS,
                         ids=[f"p{p}-pt{t}" for p, t in LOSSLESS])
def test_sof3_gray_decodes_as_imageio(tmp_path, predictor, pt):
    g = _scene(21, 47)[..., 0]
    got = _as_imageio(tmp_path, write_jpeg(None, g, coding="lossless",
                                           predictor=predictor, pt=pt))
    np.testing.assert_array_equal(got, (g >> pt) << pt)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_sof3_rgb_with_restarts_decodes_to_the_pixels(tmp_path, predictor):
    """Three components interleaved, stored as written (no markers: RGB
    in lossless mode), a restart every two rows of MCUs: the predictors
    start over with each interval."""
    img = _scene(23, 37)
    for restart in (0, 37, 74):
        got = _as_imageio(tmp_path, write_jpeg(
            None, img, coding="lossless", colour="rgb", jfif=False,
            predictor=predictor, restart=restart))
        np.testing.assert_array_equal(got, img)


def test_sof3_subsampled_and_cmyk_decode_as_imageio(tmp_path):
    """4:2:0 and 4:4:0 lossless frames (replicated chroma: no fancy
    upsampling on one-sample data units), 4 components as CMYK."""
    img = _scene(21, 47)
    for sampling in (S420, [(1, 2), (1, 1), (1, 1)]):
        _as_imageio(tmp_path, write_jpeg(None, img, coding="lossless",
                                         colour="rgb", jfif=False,
                                         sampling=sampling, predictor=5))
    c4 = _scene(21, 47, 4)
    got = _as_imageio(tmp_path, write_jpeg(None, c4, coding="lossless",
                                           jfif=False, predictor=6))
    np.testing.assert_array_equal(255 - got, c4)


REFUSED = [
    ("ycbcr", dict(colour="rgb"), "lossless JPEG in YCbCr"),
    ("adobe1", dict(colour="rgb", jfif=False, adobe=1),
     "lossless JPEG in YCbCr"),
    ("ycck", dict(colour="ycck", jfif=False, adobe=2, cmyk=True),
     "lossless JPEG in YCCK"),
    ("restart", dict(colour="rgb", jfif=False, restart=20),
     "restart interval of 20 MCUs, not whole MCU rows of 37")]


@pytest.mark.parametrize("kw,name", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_lossless_modes_both_readers_refuse(tmp_path, kw, name):
    kw = dict(kw)
    img = _scene(23, 37, 4 if kw.pop("cmyk", False) else 3)
    path = tmp_path / "f.jpg"
    write_jpeg(str(path), img, coding="lossless", **kw)
    with pytest.raises(Exception):
        imageio.imread(str(path))
    with pytest.raises(ValueError, match=f"f.jpg: .*{name}"):
        im.read_image(str(path))


# ------------------------------------------------ a COLMAP scene of them

MODES = [dict(sampling=[(1, 2), (1, 1), (1, 1)]),
         dict(sampling=S420, coding="arithmetic", restart=2),
         dict(sampling=S420, coding="arithmetic", progressive=True),
         dict(coding="lossless", colour="rgb", jfif=False, predictor=7),
         dict(colour="ycck", adobe=2, jfif=False)]


def test_colmap_scene_of_every_mode_matches_jax(tmp_path):
    """Ten frames, the modes in turn (CMYK composited as alpha by both
    loaders), through the COLMAP loaders at full size and halved."""
    root = str(tmp_path / "scene")
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.RandomState(0)
    images = []
    for i in range(10):
        kw = dict(MODES[i % len(MODES)])
        name = f"im{(7 * i) % 10:03d}.jpg"
        img = _scene(16, 20, 4 if kw.get("colour") == "ycck" else 3,
                     seed=i)
        write_jpeg(os.path.join(root, "images", name), img, quality=90,
                   **kw)
        q = rng.randn(4)
        images.append((i + 1, q / np.linalg.norm(q),
                       rng.randn(3) + [0, 0, -4], 1, name, []))
    points = [(i, rng.normal(0, 0.5, 3), (100, 110, 120), 0.1, [])
              for i in range(20)]
    write_model(os.path.join(root, "sparse/0"),
                [(1, 1, 20, 16, (100.0, 90.0, 10.0, 8.0))], images, points)
    for split, ds in (("train", 1.0), ("test", 0.5)):
        got, want = both("colmap", root, split=split, downsample=ds)
        same_dataset(got, want)
