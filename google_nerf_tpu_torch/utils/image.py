"""Image input and output of the port, with no image library.

  * read_image: PNG (8- and 16-bit gray, gray+alpha, RGB, RGBA; 1- to
    8-bit palette images, expanded to RGB as imageio gives them; Adam7),
    JPEG (8-bit: Huffman or arithmetic-coded, sequential or progressive,
    and lossless; gray, three components as RGB, or four as Pillow's
    inverted CMYK) and OpenEXR (single-part scanline files, HALF or
    FLOAT R,G,B[,A] or Y, compressed NO, RLE, ZIPS or ZIP), picked by the
    file's magic bytes as imageio does;
  * write_png (8-bit gray, RGB and RGBA; 16-bit gray) and write_jpeg
    (baseline 4:2:0 or gray, at a quality);
  * resize_linear / resize_nearest: cv2.resize's INTER_LINEAR and
    INTER_NEAREST sample positions on float images;
  * depth2img: depth maps through a 256-entry Turbo colour table;
  * colorize_rainbow: matplotlib's "rainbow" colour map, without
    matplotlib.

PNG's zlib (inflate and deflate) is the standard library's.  The per-row
PNG unfiltering, the JPEG codec and the OpenEXR reader are C
(csrc/image_codec.c, linked to zlib), built with the host C compiler at
first use into build/kernels and loaded with ctypes; a failed build
raises, and so does a file the reader cannot read, with its path and
the mode's name.  JPEG decoding reproduces libjpeg-turbo's default path
(islow IDCT, fancy upsampling, its colour rules), so it gives what
imageio (Pillow) gives.  16-bit colour PNGs keep their 16 bits (Pillow
reads them as 8).  Refused by name, as imageio refuses them:
arithmetic-coded lossless, hierarchical and 12- or 16-bit JPEGs,
lossless JPEGs in YCbCr or YCCK; PIZ, PXR24, B44/B44A and DWAA/DWAB
OpenEXR compressions, and tiled, multi-part, deep and long-name OpenEXR
files.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np
import torch

from google_nerf_tpu_torch.ops.cuda import _build

# Turbo: Anton Mikhailov's polynomial fit of the colour map, tabulated
# at 256 points (red, green, blue in [0, 1])
_R4 = (0.13572138, 4.61539260, -42.66032258, 132.13108234)
_G4 = (0.09140261, 2.19418839, 4.84296658, -14.18503333)
_B4 = (0.10667330, 12.64194608, -60.58204836, 110.36276771)
_R2 = (-152.94239396, 59.28637943)
_G2 = (4.27729857, 2.82956604)
_B2 = (-89.90310912, 27.34824973)


def _turbo_table() -> np.ndarray:
    x = np.linspace(0.0, 1.0, 256)
    v4 = np.stack([np.ones_like(x), x, x ** 2, x ** 3], -1)
    v2 = np.stack([x ** 4, x ** 5], -1)
    rgb = np.stack([v4 @ np.array(a) + v2 @ np.array(b)
                    for a, b in ((_R4, _R2), (_G4, _G2), (_B4, _B2))], -1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


TURBO = _turbo_table()      # (256, 3) uint8


def depth2img(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8: min-max normalised, then Turbo."""
    depth = np.asarray(depth, np.float64)
    d = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
    return TURBO[(d * 255).astype(np.uint8)]


def _rainbow_table() -> np.ndarray:
    """matplotlib's "rainbow" (gnuplot functions 33, 13, 10: red
    |2x - 0.5|, green sin(pi x), blue cos(pi x / 2)) at its 256 entries,
    quantised as `(cmap(d)[..., :3] * 255).astype(np.uint8)` does."""
    x = np.linspace(0.0, 1.0, 256)
    lut = np.clip(np.stack([np.abs(2 * x - 0.5), np.sin(x * np.pi),
                            np.cos(x * np.pi / 2)], -1), 0.0, 1.0)
    return (lut * 255).astype(np.uint8)


RAINBOW = _rainbow_table()  # (256, 3) uint8


def colorize_rainbow(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 RGB: min-max normalised, then
    matplotlib's "rainbow" map, its bin of each value as
    Colormap.__call__ picks it (x * 256 in the input's float type,
    truncated, 1.0 in the last bin; NaN black)."""
    depth = np.asarray(depth)
    d = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
    xa = np.array(d, copy=True)
    xa *= 256
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), 0, 255).astype(np.int64)
    rgb = RAINBOW[idx]
    rgb[bad] = 0
    return rgb


PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"
EXR_MAGIC = b"\x76\x2f\x31\x01"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}    # by colour type
_PNG_TYPE_OF = {1: 0, 3: 2, 4: 6}                 # channels -> colour type


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image, or a
    uint16 (H, W) gray image, -> a PNG, every row unfiltered."""
    img = np.asarray(img)
    sixteen = img.dtype == np.uint16
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _PNG_TYPE_OF or (
            sixteen and img.shape[2] != 1):
        raise ValueError("write_png takes (H, W) uint8 or uint16, or "
                         f"(H, W, 3|4) uint8 images, got {img.shape} "
                         f"{img.dtype}")
    h, w, c = img.shape
    rows = (img.astype(">u2").view(np.uint8) if sixteen
            else np.ascontiguousarray(img, np.uint8)).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 16 if sixteen else 8,
                       _PNG_TYPE_OF[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _declare(lib):
    p, sz, i32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.png_unfilter.argtypes = [p, sz, p, i32, i32, i32, i32]
    lib.jpeg_info.argtypes = [p, sz, ip, ip, ip, ctypes.c_char_p, i32]
    lib.jpeg_decode.argtypes = [p, sz, p, ctypes.c_char_p, i32]
    lib.jpeg_encode.argtypes = [p, i32, i32, i32, i32, p, sz]
    lib.exr_info.argtypes = [p, sz, ip, ip, ip, ctypes.c_char_p, i32]
    lib.exr_decode.argtypes = [p, sz, p, ctypes.c_char_p, i32]
    for f in ("png_unfilter", "jpeg_info", "jpeg_decode", "exr_info",
              "exr_decode"):
        getattr(lib, f).restype = i32
    lib.jpeg_encode.restype = sz


def codec():
    """csrc/image_codec.c's library, built at first use."""
    return _build.load("image_codec", _declare)


def _ptr(buf) -> ctypes.c_void_p:
    if isinstance(buf, np.ndarray):
        return ctypes.c_void_p(buf.ctypes.data)
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8, or uint16 for 16-bit
    files; palette images come out RGB (their tRNS ignored, as imageio
    reads them)."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth}")
    ch = _PNG_CHANNELS[ctype]
    bits = depth * ch
    raw = zlib.decompress(b"".join(idat))
    rowbytes = (w * bits + 7) // 8
    out = np.empty(h * rowbytes, np.uint8)
    if codec().png_unfilter(_ptr(raw), len(raw), _ptr(out), w, h, bits,
                            interlace) != 0:
        raise ValueError("corrupt PNG data (short stream or bad filter)")
    if depth == 16:
        img = out.view(">u2").reshape(h, w, ch).astype(np.uint16)
    elif depth == 8:
        img = out.reshape(h, w, ch)
    else:
        per = 8 // depth
        shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
        px = (out.reshape(h, rowbytes, 1) >> shifts) & ((1 << depth) - 1)
        img = px.reshape(h, rowbytes * per)[:, :w, None]
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        return plte[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes (Huffman or arithmetic-coded, sequential or
    progressive, or lossless; 8-bit) -> (H, W) gray, (H, W, 3) RGB or
    (H, W, 4) CMYK uint8, the CMYK inverted as Pillow gives it."""
    w, h, c = _jpeg_header(data)
    out = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(256)
    if codec().jpeg_decode(_ptr(data), len(data), _ptr(out), err, 256) != 0:
        raise ValueError(f"unsupported or corrupt JPEG: "
                         f"{err.value.decode()}")
    return out[..., 0] if c == 1 else out


def decode_exr(data: bytes) -> np.ndarray:
    """OpenEXR bytes -> (H, W, 3|4) float32 R,G,B[,A] or (H, W) float32
    Y, the data window's samples (HALF widened exactly)."""
    err = ctypes.create_string_buffer(512)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = codec()
    if lib.exr_info(_ptr(data), len(data), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(c), err, 512) != 0:
        raise ValueError(f"unsupported or corrupt OpenEXR: "
                         f"{err.value.decode()}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    if lib.exr_decode(_ptr(data), len(data), _ptr(out), err, 512) != 0:
        raise ValueError(f"unsupported or corrupt OpenEXR: "
                         f"{err.value.decode()}")
    return out[..., 0] if c.value == 1 else out


def image_size(path: str):
    """(width, height) of an image file: a PNG's or JPEG's from its
    header, an OpenEXR's from its samples."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_MAGIC:
        return struct.unpack(">II", data[16:24])
    if data[:2] == JPEG_MAGIC:
        return _jpeg_header(data)[:2]
    return read_image(path).shape[1::-1]


def _jpeg_header(data: bytes):
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if codec().jpeg_info(_ptr(data), len(data), ctypes.byref(w),
                         ctypes.byref(h), ctypes.byref(c), err, 256) != 0:
        raise ValueError(f"unsupported or corrupt JPEG: "
                         f"{err.value.decode()}")
    return w.value, h.value, c.value


_DECODERS = ((PNG_MAGIC, decode_png), (JPEG_MAGIC, decode_jpeg),
             (EXR_MAGIC, decode_exr))


def read_image(path: str) -> np.ndarray:
    """A PNG, JPEG or OpenEXR file -> its samples (decode_png /
    decode_jpeg / decode_exr), the format picked by its magic bytes; a
    file none of them reads raises ValueError with its path."""
    with open(path, "rb") as f:
        data = f.read()
    for magic, decode in _DECODERS:
        if data.startswith(magic):
            try:
                return decode(data)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: neither PNG, JPEG nor OpenEXR")


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """(H, W, 3) RGB uint8 -> a baseline 4:2:0 JPEG; (H, W) -> gray."""
    img = np.ascontiguousarray(img, np.uint8)
    nc = 1 if img.ndim == 2 else img.shape[2]
    if nc not in (1, 3):
        raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    cap = 4 * img.size + 4096
    out = np.empty(cap, np.uint8)
    n = codec().jpeg_encode(_ptr(img), w, h, nc, int(quality), _ptr(out),
                            cap)
    if n == 0:
        raise RuntimeError("JPEG encoder overflowed its buffer")
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())


def _linear_taps(n_in: int, n_out: int):
    """cv2.resize INTER_LINEAR's taps along one axis: src = (dst + 0.5) *
    n_in / n_out - 0.5 in float32, clamped to the edge samples."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0.astype(np.float32)).astype(np.float32)
    lo, hi = i0 < 0, i0 >= n_in - 1
    frac[lo | hi] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.from_numpy(1.0 - frac), torch.from_numpy(frac))


def resize_linear(img: torch.Tensor, size) -> torch.Tensor:
    """(H, W[, C]) float image -> (h, w[, C]) for size = (w, h), with
    cv2.resize's INTER_LINEAR sample positions (no antialiasing):
    horizontal taps first, then vertical, in float32, on img's device."""
    img = torch.as_tensor(img, dtype=torch.float32)
    w, h = int(size[0]), int(size[1])
    x0, x1, ax0, ax1 = (t.to(img.device)
                        for t in _linear_taps(img.shape[1], w))
    y0, y1, by0, by1 = (t.to(img.device)
                        for t in _linear_taps(img.shape[0], h))
    extra = (None,) * (img.ndim - 2)
    rows = (img[:, x0] * ax0[(None, slice(None)) + extra]
            + img[:, x1] * ax1[(None, slice(None)) + extra])
    return (rows[y0] * by0[(slice(None), None) + extra]
            + rows[y1] * by1[(slice(None), None) + extra])


def resize_nearest(img: torch.Tensor, size) -> torch.Tensor:
    """(H, W[, C]) image -> (h, w[, C]) for size = (w, h), with
    cv2.resize's INTER_NEAREST source index floor(dst / (n_out / n_in))."""
    img = torch.as_tensor(img)
    w, h = int(size[0]), int(size[1])

    def idx(n_in, n_out):
        i = np.floor(np.arange(n_out) * (1.0 / (n_out / n_in)))
        return torch.from_numpy(np.minimum(i.astype(np.int64),
                                           n_in - 1)).to(img.device)

    return img[idx(img.shape[0], h)][:, idx(img.shape[1], w)]
