"""The port's progressive JPEG and OpenEXR reading (csrc/image_codec.c
through utils/image.py) on the CPU.

  * Progressive JPEG: Pillow-written files at 67x93 (not a multiple of
    the MCU), 4:4:4, 4:2:2, 4:2:0 and gray, qualities 75 and 95, with and
    without restart markers, with and without optimize=True (libjpeg's
    standard progression: DC first at Al 1, AC bands 1-5 and 6-63 at Al
    2 and 1, then the refinements).  Each decode is held against
    imageio.imread within the baseline bound (max 2, mean 0.1 of 255),
    against the port's decode of the baseline file of the same pixels,
    quality and subsampling (bit for bit: both carry the same quantised
    coefficients), and the port's data/loaders.decode_image against the
    JAX package's on the file (equal);
  * OpenEXR: files of tools/exr_fixture.py (written from the file-layout
    specification, sharing no code with the reader): NO, RLE, ZIPS and
    ZIP x HALF and FLOAT x RGB, RGBA and Y x INCREASING_Y and
    DECREASING_Y at 37 rows (not a multiple of ZIP's 16-line chunk), with
    NaN, infinities, signed zero and subnormals; mixed pixel types, a data
    window off the origin, incompressible chunks stored raw; all bit for
    bit against the array written.  A 2x2 HALF RGB NO-compression file
    whose bytes this file lays out by hand catches a misreading that the
    writer and the reader would share;
  * the modes still refused, each by its name and by imageio too:
    arithmetic-coded lossless, hierarchical, 12- and 16-bit JPEGs (files
    crafted here; tests/test_torch_jpeg_modes.py holds the modes that
    decode and the lossless files both readers refuse), and
    the PIZ, PXR24, B44, B44A, DWAA and DWAB compressions, tiled,
    multi-part, deep and long-name files, UINT and subsampled channels
    and channel sets other than R,G,B[,A] or Y; a file that cannot be
    read raises with its path.
"""
import os
import struct

import numpy as np
import pytest

from google_nerf_tpu.data import loaders as jl
from google_nerf_tpu_torch.data import loaders as tl
from google_nerf_tpu_torch.tools.exr_fixture import write_exr
from google_nerf_tpu_torch.utils import image as im

imageio = pytest.importorskip("imageio.v2")
Image = pytest.importorskip("PIL.Image")


def _scene_image(h, w):
    """A smooth image with edges and some noise (JPEG-like content)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 128,
                    (x * 3 + y * 2) % 256], -1)
    img[(x // 9 + y // 9) % 2 == 0] *= 0.6
    img += np.random.RandomState(0).randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow_jpeg(path, img, sub, **kw):
    if sub == "gray":
        Image.fromarray(img[..., 0]).save(path, "JPEG", **kw)
    else:
        Image.fromarray(img).save(path, "JPEG", subsampling=sub, **kw)
    with open(path, "rb") as f:
        return f.read()


# ----------------------------------------------------- progressive JPEG

PROGRESSIVE = [(s, q, r, o) for s in ("4:4:4", "4:2:2", "4:2:0", "gray")
               for q in (75, 95) for r in (0, 3) for o in (False, True)]


@pytest.mark.parametrize(
    "sub,quality,restart,optimize", PROGRESSIVE,
    ids=[f"{s}-q{q}-rst{r}{'-opt' if o else ''}"
         for s, q, r, o in PROGRESSIVE])
def test_progressive_jpeg_decodes_as_pillow_and_baseline(
        tmp_path, sub, quality, restart, optimize):
    img = _scene_image(67, 93)
    kw = dict(quality=quality, optimize=optimize)
    if restart:
        kw["restart_marker_blocks"] = restart
    path = str(tmp_path / "p.jpg")
    data = _pillow_jpeg(path, img, sub, progressive=True, **kw)
    base = _pillow_jpeg(str(tmp_path / "b.jpg"), img, sub, **kw)
    assert b"\xff\xc2" in data and b"\xff\xc0" in base
    assert (b"\xff\xdd" in data) == bool(restart)
    assert data.count(b"\xff\xda") > 1               # several scans
    got = im.decode_jpeg(data)
    want = imageio.imread(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 2 and diff.mean() <= 0.1
    np.testing.assert_array_equal(got, im.decode_jpeg(base))
    np.testing.assert_array_equal(im.read_image(path), got)
    wh = (93, 67)
    np.testing.assert_array_equal(tl.decode_image(path, wh),
                                  jl.decode_image(path, wh))


def test_progressive_jpeg_at_odd_sizes_and_qualities(tmp_path):
    """Sizes of one block, one row and a narrow column; qualities 10 to
    100: long EOB runs, ZRL codes and many refinement bits."""
    from PIL import ImageFile
    rng = np.random.RandomState(1)
    path = str(tmp_path / "p.jpg")
    for h, w in ((1, 1), (8, 8), (17, 9), (120, 161), (600, 3)):
        y, x = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([
            np.sin(x / 3.0) * 100 + 120 + rng.randn(h, w) * 30,
            np.cos(y / 2.0) * 90 + 128, rng.randint(0, 256, (h, w))], -1),
            0, 255).astype(np.uint8)
        for q in (10, 50, 100):
            for sub in ("4:2:0", "4:4:4"):
                block = ImageFile.MAXBLOCK
                ImageFile.MAXBLOCK = 1 << 22    # Pillow's progressive
                try:                            # encoder needs the room
                    _pillow_jpeg(path, img, sub, quality=q,
                                 progressive=True)
                finally:
                    ImageFile.MAXBLOCK = block
                np.testing.assert_array_equal(
                    im.read_image(path), imageio.imread(path),
                    err_msg=f"{h}x{w} q{q} {sub}")


# ------------------------------------------------------------- OpenEXR

def _exr_content(h, w, c, pixel_type, seed=0):
    """Smooth samples (so ZIP and RLE compress them) with a few special
    values: NaN, +-inf, -0.0, and the type's subnormals."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 5.0 + k) * np.cos(y / 3.0) * (k + 1)
                    for k in range(c)], -1).astype(np.float32)
    img[:, : w // 2] = 0.5                        # runs for RLE
    special = [np.nan, np.inf, -np.inf, -0.0,
               6e-8 if pixel_type == "HALF" else 1e-40, 65504.0]
    for k, v in enumerate(special):
        img[rng.randint(h), rng.randint(w), rng.randint(c)] = v
    return img if c > 1 else img[..., 0]


def _as_type(img, pixel_type):
    return img.astype(np.float16).astype(np.float32) \
        if pixel_type == "HALF" else img.astype(np.float32)


def _same_bits(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.view(np.uint32))


EXR_CASES = [(c, t, n, o) for c in ("NO", "RLE", "ZIPS", "ZIP")
             for t in ("HALF", "FLOAT") for n in (3, 4, 1)
             for o in ("INCREASING_Y", "DECREASING_Y")]


@pytest.mark.parametrize(
    "compression,pixel_type,channels,line_order", EXR_CASES,
    ids=[f"{c}-{t}-{'Y' if n == 1 else 'RGBA'[:n]}-{o.split('_')[0]}"
         for c, t, n, o in EXR_CASES])
def test_exr_reads_back_bit_exact(tmp_path, compression, pixel_type,
                                  channels, line_order):
    h, w = 37, 23                   # 37 rows: ZIP's last chunk holds 5
    img = _exr_content(h, w, channels, pixel_type)
    path = str(tmp_path / "f.exr")
    write_exr(path, img, compression=compression, pixel_type=pixel_type,
              line_order=line_order)
    if compression != "NO":         # the chunks really went compressed
        plain = str(tmp_path / "no.exr")
        write_exr(plain, img, compression="NO", pixel_type=pixel_type)
        assert os.path.getsize(path) < os.path.getsize(plain)
    _same_bits(im.read_image(path), _as_type(img, pixel_type))
    assert im.image_size(path) == (w, h)


def test_exr_mixed_types_window_origin_and_raw_chunks(tmp_path):
    rng = np.random.RandomState(3)
    h, w = 21, 19
    smooth = _exr_content(h, w, 4, "FLOAT", seed=3)
    types = {"A": "HALF", "B": "FLOAT", "G": "HALF", "R": "FLOAT"}
    chans = {k: smooth[..., i] for i, k in enumerate("RGBA")}
    want = np.stack([_as_type(chans[k], types[k]) for k in "RGBA"], -1)
    for compression in ("ZIP", "RLE", "ZIPS"):
        path = str(tmp_path / f"{compression}.exr")
        write_exr(path, chans, compression=compression, pixel_type=types,
                  origin=(-7, 1000))
        _same_bits(im.read_image(path), want)
    # noise does not compress: every chunk is stored raw beside its
    # compressed neighbours' rule, and still reads back
    noise = rng.randn(h, w, 3).astype(np.float32)
    for compression in ("ZIP", "RLE", "ZIPS"):
        path = str(tmp_path / f"noise_{compression}.exr")
        write_exr(path, noise, compression=compression, pixel_type="FLOAT")
        _same_bits(im.read_image(path), noise)


def test_exr_hand_laid_file():
    """A 2x2 HALF R,G,B file, compression NO, laid out byte by byte from
    the specification: magic 20000630, version 2; the attributes; the
    offset table of two uint64; two chunks of (int32 y, int32 size,
    one scanline: B's two halves, G's, R's)."""
    def attr(name, type_name, value):
        return (name + b"\0" + type_name + b"\0"
                + struct.pack("<i", len(value)) + value)
    chlist = b"".join(c + b"\0" + b"\x01\0\0\0" + b"\0\0\0\0"
                      + b"\x01\0\0\0" + b"\x01\0\0\0"
                      for c in (b"B", b"G", b"R")) + b"\0"
    box = b"\0\0\0\0" * 2 + b"\x01\0\0\0" * 2          # (0, 0)-(1, 1)
    header = (attr(b"channels", b"chlist", chlist)
              + attr(b"compression", b"compression", b"\0")
              + attr(b"dataWindow", b"box2i", box)
              + attr(b"displayWindow", b"box2i", box)
              + attr(b"lineOrder", b"lineOrder", b"\0")
              + attr(b"pixelAspectRatio", b"float", b"\0\0\x80\x3f")
              + attr(b"screenWindowCenter", b"v2f", b"\0" * 8)
              + attr(b"screenWindowWidth", b"float", b"\0\0\x80\x3f")
              + b"\0")
    # halves: 1.0 = 0x3c00, 0.5 = 0x3800, 2.0 = 0x4000, -1.5 = 0xbe00,
    # 0.25 = 0x3400, 65504 = 0x7bff, 2^-24 = 0x0001, -0.0 = 0x8000
    line0 = (b"\x00\x3c\x00\x38"         # B: 1.0, 0.5
             + b"\x00\x40\x00\xbe"       # G: 2.0, -1.5
             + b"\x00\x34\xff\x7b")      # R: 0.25, 65504
    line1 = (b"\x01\x00\x00\x80"         # B: 2^-24, -0.0
             + b"\x00\x00\x00\x3c"       # G: 0.0, 1.0
             + b"\x00\x7c\x00\x38")      # R: inf, 0.5
    start = 8 + len(header) + 16
    chunk0 = b"\0\0\0\0" + struct.pack("<i", 12) + line0
    data = (b"\x76\x2f\x31\x01" + b"\x02\0\0\0" + header
            + struct.pack("<QQ", start, start + len(chunk0))
            + chunk0 + b"\x01\0\0\0" + struct.pack("<i", 12) + line1)
    want = np.array([[[0.25, 2.0, 1.0], [65504.0, -1.5, 0.5]],
                     [[np.inf, 0.0, 2.0 ** -24], [0.5, 1.0, -0.0]]],
                    np.float32)
    _same_bits(im.decode_exr(data), want)


def test_exr_frame_through_decode_image(tmp_path):
    """An RGBA HALF frame through the loaders' rules: max <= 1.5, so no
    /255; the alpha composite onto the background; the linear resize."""
    rgba = np.clip(_exr_content(12, 16, 4, "HALF"), 0, 1)
    rgba = np.nan_to_num(rgba, nan=0.5)
    path = str(tmp_path / "f.exr")
    write_exr(path, rgba)
    x = _as_type(rgba, "HALF")
    want = x[..., :3] * x[..., 3:] + 1.0 * (1 - x[..., 3:])
    np.testing.assert_array_equal(tl.decode_image(path, (16, 12)),
                                  want.reshape(-1, 3))
    small = tl.decode_image(path, (8, 6))
    np.testing.assert_allclose(
        small, tl.resize_to(want, (8, 6)).reshape(-1, 3), atol=0)


# ------------------------------------------------------ refused by name

def _sof(marker, precision=8):
    """SOI, one SOF segment of an 8x8 one-component frame, a DHT of
    Annex K's luma DC table and an AC table of EOB alone, one SOS
    (predictor 1 for the lossless frames, the full band otherwise) over
    eight zero bytes, EOI: a file both readers decode when the marker is
    SOF0 at 8 bits."""
    lossless = marker in (0xC3, 0xC7, 0xCB, 0xCF)
    dht = (b"\xff\xc4" + struct.pack(">H", 2 + 17 + 12 + 17 + 1) + b"\x00"
           + bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
           + bytes(range(12)) + b"\x10" + bytes([1] + [0] * 15) + b"\x00")
    sos = (b"\xff\xda" + struct.pack(">HB", 8, 1) + b"\x01\x00"
           + (b"\x01\x00\x00" if lossless else b"\x00\x3f\x00"))
    dqt = b"\xff\xdb\x00\x43\x00" + bytes([1] * 64)
    return (b"\xff\xd8" + dqt + bytes([0xFF, marker]) + struct.pack(
        ">HBHHB", 11, precision, 8, 8, 1) + b"\x01\x11\x00" + dht + sos
        + bytes(8) + b"\xff\xd9")


def test_the_crafted_frame_decodes_at_sof0(tmp_path):
    """The refused cases below differ from this file in the SOF marker
    and the precision alone."""
    path = tmp_path / "f.jpg"
    path.write_bytes(_sof(0xC0))
    np.testing.assert_array_equal(im.read_image(str(path)),
                                  imageio.imread(str(path)))


# arithmetic sequential and progressive (SOF9, SOF10) and lossless SOF3
# decode now (tests/test_torch_jpeg_modes.py); these stay refused, and
# imageio refuses each file too
JPEG_REFUSED = [(0xCB, 8, "arithmetic-coded lossless"),
                (0xCD, 8, "hierarchical"), (0xCE, 8, "hierarchical"),
                (0xCF, 8, "hierarchical"), (0xC7, 8, "hierarchical"),
                (0xC5, 8, "hierarchical"), (0xC6, 8, "hierarchical"),
                (0xC1, 12, "12-bit"), (0xC2, 12, "12-bit"),
                (0xC3, 12, "12-bit"), (0xC9, 12, "12-bit"),
                (0xC3, 16, "16-bit")]


@pytest.mark.parametrize("marker,precision,name", JPEG_REFUSED,
                         ids=[f"SOF{m - 0xC0}-{p}bit"
                              for m, p, _ in JPEG_REFUSED])
def test_jpeg_refuses_mode_by_name(tmp_path, marker, precision, name):
    path = tmp_path / "f.jpg"
    path.write_bytes(_sof(marker, precision))
    with pytest.raises(Exception):
        imageio.imread(str(path))
    with pytest.raises(ValueError, match=f"f.jpg: .*{name} JPEG"):
        im.read_image(str(path))


def _patched(path, find: bytes, new: bytes):
    data = path.read_bytes()
    assert data.count(find) == 1
    path.write_bytes(data.replace(find, new))


EXR_COMPRESSIONS = ["PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB"]


@pytest.mark.parametrize("code,name", list(enumerate(EXR_COMPRESSIONS, 4)),
                         ids=EXR_COMPRESSIONS)
def test_exr_refuses_compression_by_name(tmp_path, code, name):
    path = tmp_path / "f.exr"
    write_exr(str(path), np.zeros((4, 4, 3), np.float32), compression="NO")
    key = b"compression\0compression\0\x01\0\0\0"
    _patched(path, key + b"\0", key + bytes([code]))
    with pytest.raises(ValueError, match=f"f.exr: .*{name}-compressed"):
        im.read_image(str(path))


EXR_FLAGS = [(0x200, "tiled"), (0x1000, "multi-part"),
             (0x800, "deep"), (0x400, "long-name")]


@pytest.mark.parametrize("flag,name", EXR_FLAGS,
                         ids=[n for _, n in EXR_FLAGS])
def test_exr_refuses_layout_by_name(tmp_path, flag, name):
    path = tmp_path / "f.exr"
    write_exr(str(path), np.zeros((4, 4, 3), np.float32), compression="NO")
    data = bytearray(path.read_bytes())
    data[4:8] = struct.pack("<I", 2 | flag)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"f.exr: .*{name} OpenEXR"):
        im.read_image(str(path))


def test_exr_refuses_channels_by_name(tmp_path):
    z = np.zeros((4, 4), np.float32)
    for chans, match in (({"R": z, "G": z, "B": z, "Z": z}, "B,G,R,Z"),
                         ({"R": z, "G": z}, "G,R"),
                         ({"Y": z, "A": z}, "A,Y"),
                         ({"R": z, "G": z, "B": z, "Y": z}, "B,G,R,Y"),
                         ({"depth": z}, "depth")):
        path = tmp_path / "c.exr"
        write_exr(str(path), chans, compression="NO")
        with pytest.raises(ValueError, match=f"OpenEXR channels {match}: "
                           r"only R,G,B\[,A\] or Y"):
            im.read_image(str(path))
    path = tmp_path / "u.exr"
    write_exr(str(path), {"Y": z}, compression="NO", pixel_type="FLOAT")
    _patched(path, b"Y\0\x02\0\0\0", b"Y\0\x00\0\0\0")        # UINT
    with pytest.raises(ValueError, match="channel Y of pixel type UINT"):
        im.read_image(str(path))
    path = tmp_path / "s.exr"
    write_exr(str(path), {"Y": z}, compression="NO")
    _patched(path, b"\x01\0\0\0\x01\0\0\0\0", b"\x02\0\0\0\x02\0\0\0\0")
    with pytest.raises(ValueError, match="subsampled OpenEXR channel Y"):
        im.read_image(str(path))


def test_unreadable_frames_raise_with_their_path(tmp_path):
    cases = {"trunc.exr": b"\x76\x2f\x31\x01" + bytes(60),
             "trunc.jpg": b"\xff\xd8\xff\xc0\x00",
             "other.bin": b"GIF89a"}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=name):
            im.read_image(str(tmp_path / name))
    path = tmp_path / "cut.exr"
    write_exr(str(path), np.ones((20, 8, 3), np.float32))
    data = path.read_bytes()
    path.write_bytes(data[:len(data) - 9])                  # last chunk cut
    with pytest.raises(ValueError, match="cut.exr: .*OpenEXR"):
        im.read_image(str(path))
