"""The port's image codec and resampling (utils/image.py,
csrc/image_codec.c) against imageio/Pillow and cv2 on the CPU.

  * PNG: every colour type and depth the port reads, each with filters
    0-4 forced and with Adam7, written by this file's own encoder:
    decoded bit-exact against the array written and, where Pillow keeps
    the samples (8-bit types, 16-bit gray, palettes), against
    imageio.imread;
  * JPEG decoding: Pillow-written 4:4:4, 4:2:2, 4:2:0 and gray files at
    qualities 75 and 95, with and without restart markers, against
    imageio.imread: max abs <= 2 (of 255) and mean <= 0.1 (equality is
    what the decoder's design gives: libjpeg's islow IDCT and fancy
    upsampling; progressive files and the modes still refused are in
    tests/test_torch_image_formats.py, beside OpenEXR);
  * JPEG encoding: Pillow reads the port's files as the port does, and
    the textured scene's round trip at quality 95 (324x242, a quarter
    of a ScanNet colour frame) scores >= 40 dB;
  * resize_linear and resize_nearest against cv2.resize at 1296x968 ->
    640x480, 800 -> 8 and 640x480 -> 64x48: 1e-5 and exact;
  * a failed codec build raises.
"""
import io
import struct
import zlib

import numpy as np
import pytest
import torch

from google_nerf_tpu_torch.ops.cuda import _build
from google_nerf_tpu_torch.utils import image as im

imageio = pytest.importorskip("imageio.v2")
Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows, bpp, ftype):
    """rows: (h, rowbytes) uint8 -> filtered bytes with filter `ftype`."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        out.append(ftype)
        for i, x in enumerate(r):
            a = r[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((x - pred) & 255)
        prev = r
    return bytes(out)


def _pack(px, depth):
    """(h, w, ch) samples -> (h, rowbytes) uint8 as a PNG packs them."""
    h = px.shape[0]
    if depth == 16:
        return px.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    flat = px.reshape(h, -1).astype(np.uint8)
    w = flat.shape[1]
    flat = np.pad(flat, ((0, 0), (0, (-w) % per)))
    sh = np.arange(per - 1, -1, -1) * depth
    return (flat.reshape(h, -1, per) << sh).sum(-1).astype(np.uint8)


def _encode_png(path, px, depth, ctype, ftype, adam7=False, plte=None):
    h, w = px.shape[:2]
    ch = px.shape[2]
    bpp = max(1, depth * ch // 8)
    if adam7:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = px[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack(sub, depth), bpp, ftype)
    else:
        raw = _filter_rows(_pack(px, depth), bpp, ftype)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, int(adam7))))
        if plte is not None:
            f.write(chunk(b"PLTE", plte.astype(np.uint8).tobytes()))
        f.write(chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(chunk(b"IEND", b""))


# (channels or "palette", bit depth, whether Pillow keeps every sample)
PNG_CASES = [(1, 8, True), (1, 16, True), (2, 8, True), (2, 16, False),
             (3, 8, True), (3, 16, False), (4, 8, True), (4, 16, False),
             ("palette", 8, True), ("palette", 4, True), ("palette", 2, True),
             ("palette", 1, True)]


@pytest.mark.parametrize("ch,depth,pillow_exact", PNG_CASES,
                         ids=[f"{c}-{d}" for c, d, _ in PNG_CASES])
def test_png_decodes_bit_exact(tmp_path, ch, depth, pillow_exact):
    rng = np.random.RandomState(depth)
    h, w = 13, 11            # odd sizes: partial Adam7 passes and bytes
    plte = None
    if ch == "palette":
        px = rng.randint(0, 1 << depth, (h, w, 1))
        plte = rng.randint(0, 256, (1 << depth, 3))
        want = plte[px[..., 0]].astype(np.uint8)
        ctype = 3
    else:
        px = rng.randint(0, 1 << depth, (h, w, ch))
        want = px.astype(np.uint16 if depth == 16 else np.uint8)
        want = want[..., 0] if ch == 1 else want
        ctype = COLOR_TYPE[ch]
    for ftype in range(5):
        for adam7 in (False, True):
            p = str(tmp_path / f"f{ftype}_{int(adam7)}.png")
            _encode_png(p, px, depth, ctype, ftype, adam7, plte)
            got = im.read_image(p)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"filter {ftype} {adam7}")
            if pillow_exact:
                np.testing.assert_array_equal(got, imageio.imread(p))


def test_png_writer_gray16_and_rgba_read_back(tmp_path):
    rng = np.random.RandomState(0)
    d = rng.randint(0, 65536, (9, 7)).astype(np.uint16)
    rgba = rng.randint(0, 256, (9, 7, 4)).astype(np.uint8)
    gray = rng.randint(0, 256, (9, 7)).astype(np.uint8)
    for name, a in (("d", d), ("rgba", rgba), ("gray", gray)):
        p = str(tmp_path / f"{name}.png")
        im.write_png(p, a)
        np.testing.assert_array_equal(imageio.imread(p), a)
        np.testing.assert_array_equal(im.read_image(p), a)
    assert im.image_size(str(tmp_path / "rgba.png")) == (7, 9)


def _scene_image(h, w):
    """A smooth image with edges and some noise (JPEG-like content)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 128,
                    (x * 3 + y * 2) % 256], -1)
    img[(x // 9 + y // 9) % 2 == 0] *= 0.6
    img += np.random.RandomState(0).randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


JPEG_CASES = [(s, q, r) for s in ("4:4:4", "4:2:2", "4:2:0", "gray")
              for q in (75, 95) for r in (0, 3)]


@pytest.mark.parametrize("sub,quality,restart", JPEG_CASES,
                         ids=[f"{s}-q{q}-rst{r}" for s, q, r in JPEG_CASES])
def test_jpeg_decode_matches_pillow(sub, quality, restart):
    img = _scene_image(67, 93)          # not a multiple of the MCU
    buf = io.BytesIO()
    kw = dict(quality=quality)
    if restart:
        kw["restart_marker_blocks"] = restart
    if sub == "gray":
        Image.fromarray(img[..., 0]).save(buf, "JPEG", **kw)
    else:
        Image.fromarray(img).save(buf, "JPEG", subsampling=sub, **kw)
    data = buf.getvalue()
    assert (b"\xff\xdd" in data) == bool(restart)
    want = imageio.imread(data).astype(np.int64)
    got = im.decode_jpeg(data).astype(np.int64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    print(f"{sub} q{quality} restart {restart}: max abs {diff.max()}, mean "
          f"{diff.mean()}")
    assert diff.max() <= 2 and diff.mean() <= 0.1


def test_jpeg_encoder_round_trip(tmp_path, monkeypatch):
    from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(tmp_path / "gt"))
    # a quarter of a ScanNet colour frame (1296x968): at much smaller
    # sizes the scene's fine checker is beyond 4:2:0's chroma (Pillow's
    # own 4:2:0 encoder scores the same as the port's there)
    ds = SyntheticDataset(split="test", n_images=1, img_wh=(324, 242),
                          style="textured", device="cpu")
    img = (ds.rays[0].reshape(242, 324, 3) * 255 + 0.5).astype(np.uint8)
    for arr, name in ((img, "rgb"), (img[..., 1], "gray")):
        p = str(tmp_path / f"{name}.jpg")
        im.write_jpeg(p, arr, quality=95)
        pil = imageio.imread(p)
        np.testing.assert_array_equal(im.read_image(p), pil)
        mse = np.mean((pil.astype(np.float64) - arr) ** 2)
        psnr = 10 * np.log10(255.0 ** 2 / mse)
        print(f"{name}: round trip {psnr:.2f} dB")
        assert psnr >= 40.0


@pytest.mark.parametrize("src,dst", [((1296, 968), (640, 480)),
                                     ((800, 800), (8, 8)),
                                     ((640, 480), (64, 48))])
def test_resize_matches_cv2(src, dst):
    rng = np.random.RandomState(0)
    img = cv2.GaussianBlur(rng.rand(src[1], src[0], 3).astype(np.float32),
                           (0, 0), 2)
    got = im.resize_linear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_allclose(got, cv2.resize(img, dst), atol=1e-5)
    depth = rng.rand(src[1], src[0]).astype(np.float32)
    near = im.resize_nearest(torch.from_numpy(depth), dst).numpy()
    np.testing.assert_array_equal(
        near, cv2.resize(depth, dst, interpolation=cv2.INTER_NEAREST))


def test_codec_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="image_codec"):
        _build.build("image_codec")
