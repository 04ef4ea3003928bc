"""A JPEG writer for fixtures: every coding mode the port's reader takes,
written from ITU-T T.81 with numpy and csrc/jpeg_fixture.c's entropy
coders (no image library).

It shares no code with the port's reader (csrc/image_codec.c), so a
file it writes that an independent decoder (imageio) reads as intended
checks the reader against the standard rather than against this writer.

    data = write_jpeg(path, img, quality=90, sampling=((1, 2), (1, 1),
                      (1, 1)), coding="arithmetic", progressive=True)

img: (H, W) gray, (H, W, 3) RGB or (H, W, 4) CMYK samples (uint8).
colour: how three or four channels are stored: "ycc" (YCbCr, the
default for three), "rgb", "cmyk" (as given, the default for four) or
"ycck" (C, M, Y inverted to R, G, B, then YCbCr; K as given).
sampling: (h, v) of each component (default all 1x1).  coding:
"huffman" (SOF0, or SOF2 with progressive=True), "arithmetic" (SOF9,
SOF10) or "lossless" (SOF3, Huffman; predictor 1-7, point transform
pt).  jfif: write the JFIF APP0; adobe: None or the APP14 Adobe
transform (0, 1, 2), written before the APP0 if adobe_first; ids: the
component ids (default 1, 2, ...).  restart: MCUs a restart interval
(DRI).  dac: (L, U, Kx) written in a DAC segment for every table used
(arithmetic; None leaves the defaults 0, 1, 5).  Progressive files
follow libjpeg's jpeg_simple_progression script (simple_progression).

The DCT modes share one forward DCT and quantisation (libjpeg's quality
scaling of the Annex K tables, rounding to the nearest level), so every
coding of one image, quality and sampling holds the same coefficients:
an arithmetic file and its Huffman twin decode to the same samples.

chip_smoke.py writes its COLMAP scene's frames with it; the tests write
their JPEG cases with it.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from google_nerf_tpu_torch.ops.cuda import _build

STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# Annex K.3's tables: bits[1..16], values
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1"
    " 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26"
    " 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56"
    " 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85"
    " 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa"
    " b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6"
    " d7 d8 d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9"
    " fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             bytes.fromhex(
    "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42"
    " 91 a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19"
    " 1a 26 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55"
    " 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83"
    " 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8"
    " a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4"
    " d5 d6 d7 d8 d9 da e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9"
    " fa"))
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
SOF = {("huffman", False): 0xC0, ("huffman", True): 0xC2,
       ("arithmetic", False): 0xC9, ("arithmetic", True): 0xCA,
       ("lossless", False): 0xC3}


def _declare(lib):
    p, sz, i32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    lib.fx_huff_scan.argtypes = [i32, i32, p, p, i32, i32, i32, i32, i32,
                                 i32, i32, p, p, p, sz]
    lib.fx_arith_scan.argtypes = [i32, i32, p, p, i32, i32, i32, i32, i32,
                                  i32, i32, p, p, sz]
    lib.fx_lossless_scan.argtypes = [i32, p, p, i32, i32, i32, i32, i32, p,
                                     p, sz]
    for f in ("fx_huff_scan", "fx_arith_scan", "fx_lossless_scan"):
        getattr(lib, f).restype = sz


def coder():
    """csrc/jpeg_fixture.c's library, built at first use."""
    return _build.load("jpeg_fixture", _declare)


def simple_progression(nc: int):
    """libjpeg's jpeg_simple_progression script for nc components: DC
    first at Al 1; the bands of the first component at Al 2 and of the
    others at Al 1; the refinements.  Holds all four scan kinds."""
    comps = tuple(range(nc))
    if nc == 3:
        return [(comps, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), (comps, 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    return ([(comps, 0, 0, 0, 1)]
            + [((c,), 1, 5, 0, 2) for c in comps]
            + [((c,), 6, 63, 0, 2) for c in comps]
            + [((c,), 1, 63, 2, 1) for c in comps]
            + [(comps, 0, 0, 1, 0)]
            + [((c,), 1, 63, 1, 0) for c in comps])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of an Annex K table (natural
    order), each entry clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _planes(img: np.ndarray, colour: str) -> np.ndarray:
    """(H, W[, C]) uint8 -> (C, H, W) float64 component samples."""
    x = np.asarray(img, np.float64)
    if x.ndim == 2:
        return x[None]
    if colour in ("ycc", "ycck"):
        rgb = 255.0 - x[..., :3] if colour == "ycck" else x[..., :3]
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        ycc = [0.299 * r + 0.587 * g + 0.114 * b,
               -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
               0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
        x = np.stack(ycc + ([x[..., 3]] if colour == "ycck" else []), -1)
        x = np.clip(np.round(x), 0, 255)
    return np.moveaxis(x, -1, 0)


def _downsample(plane, sx, sy, dw, dh):
    """Box averages of sx x sy samples (edges replicated) -> (dh, dw)."""
    h, w = plane.shape
    p = np.pad(plane, ((0, dh * sy - h), (0, dw * sx - w)), mode="edge")
    return p.reshape(dh, sy, dw, sx).mean((1, 3))


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2.0)
    return c


class Frame:
    """The components of one image at one sampling: samples (lossless)
    and quantised coefficients (the DCT modes), with the frame's
    geometry."""

    def __init__(self, img, quality=90, sampling=None, colour=None):
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
                img.ndim == 3 and img.shape[2] not in (3, 4)):
            raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3|4) "
                             f"uint8, got {img.shape} {img.dtype}")
        self.h, self.w = img.shape[:2]
        self.nc = 1 if img.ndim == 2 else img.shape[2]
        self.colour = colour or {1: "gray", 3: "ycc", 4: "cmyk"}[self.nc]
        self.sampling = [tuple(s) for s in (sampling or [(1, 1)] * self.nc)]
        if len(self.sampling) != self.nc:
            raise ValueError("one (h, v) a component")
        hmax = max(s[0] for s in self.sampling)
        vmax = max(s[1] for s in self.sampling)
        self.mcux = -(-self.w // (8 * hmax))
        self.mcuy = -(-self.h // (8 * vmax))
        self.lmcux = -(-self.w // hmax)          # lossless: 1x1 units
        self.lmcuy = -(-self.h // vmax)
        self.tables = [0 if i in (0, 3) else 1 for i in range(self.nc)]
        self.q = [quant_table(STD_LUMA_Q, quality),
                  quant_table(STD_CHROMA_Q, quality)]
        C = _dct_matrix()
        self.samples, self.coef, self.geom = [], [], []
        for i, plane in enumerate(_planes(img, self.colour)):
            h, v = self.sampling[i]
            if hmax % h or vmax % v:
                raise ValueError("sampling factors must divide the largest")
            dw = -(-self.w * h // hmax)
            dh = -(-self.h * v // vmax)
            down = _downsample(plane, hmax // h, vmax // v, dw, dh)
            self.samples.append(np.clip(np.round(down), 0, 255)
                                .astype(np.uint8))
            bw, bh = self.mcux * h, self.mcuy * v
            pad = np.pad(down, ((0, bh * 8 - dh), (0, bw * 8 - dw)),
                         mode="edge") - 128.0
            blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
            f = C @ blocks @ C.T
            q = self.q[self.tables[i]].reshape(8, 8)
            self.coef.append(np.ascontiguousarray(
                np.round(f / q).reshape(bh, bw, 64).astype(np.int16)))
            self.geom.append((bw, h, v, -(-dw // 8), -(-dh // 8), dw, dh))


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _table_bytes(spec) -> np.ndarray:
    bits, vals = spec
    out = np.zeros(272, np.uint8)
    out[:16] = bits
    out[16:16 + len(vals)] = list(vals)
    return out


def _dht(cls: int, tid: int, spec) -> bytes:
    bits, vals = spec
    return bytes([(cls << 4) | tid]) + bytes(bits) + bytes(vals)


JFIF = b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"


def adobe_segment(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                 transform))


def encode(frame: Frame, *, coding="huffman", progressive=False, jfif=True,
           adobe=None, adobe_first=False, ids=None, restart=0, dac=None,
           predictor=1, pt=0) -> bytes:
    """The file's bytes for `frame` in the given mode (the module's
    docstring names the options)."""
    if (coding, progressive) not in SOF:
        raise ValueError(f"no {coding} progressive mode")
    lib = coder()
    nc = frame.nc
    ids = list(ids or range(1, nc + 1))
    lossless = coding == "lossless"
    out = [b"\xff\xd8"]
    app = [_segment(0xE0, JFIF)] if jfif else []
    if adobe is not None:
        app.insert(0 if adobe_first else len(app), adobe_segment(adobe))
    out += app
    used = sorted(set(frame.tables))
    if not lossless:
        for t in used:
            out.append(_segment(0xDB, bytes([t]) + bytes(
                frame.q[t][ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, frame.h, frame.w, nc) + b"".join(
        bytes([ids[i], (frame.sampling[i][0] << 4) | frame.sampling[i][1],
               0 if lossless else frame.tables[i]]) for i in range(nc))
    out.append(_segment(SOF[coding, progressive], sof))
    dc_tabs = np.zeros((4, 272), np.uint8)
    ac_tabs = np.zeros((4, 272), np.uint8)
    if coding != "arithmetic":
        specs = ((DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA))
        body = b""
        for t in used:
            dc_tabs[t] = _table_bytes(specs[t][0])
            ac_tabs[t] = _table_bytes(specs[t][1])
            body += _dht(0, t, specs[t][0])
            if not lossless:
                body += _dht(1, t, specs[t][1])
        out.append(_segment(0xC4, body))
    luk = np.tile(np.array([0, 1, 5], np.int32), 16)
    if coding == "arithmetic" and dac is not None:
        L, U, K = dac
        body = b""
        for t in used:
            body += bytes([t, (U << 4) | L, 0x10 | t, K])
            luk[3 * t:3 * t + 3] = (L, U, K)
        out.append(_segment(0xCC, body))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    if lossless:
        script = [(tuple(range(nc)), predictor, 0, 0, pt)]
    elif progressive:
        script = simple_progression(nc)
    else:
        script = [(tuple(range(nc)), 0, 63, 0, 0)]
    cap = 8 * sum(c.size for c in frame.coef) + 65536
    buf = np.empty(cap, np.uint8)
    for comps, ss, se, ah, al in script:
        ns = len(comps)
        if lossless:
            geom = np.array([[frame.geom[i][5], frame.geom[i][6],
                              *frame.sampling[i], 0] for i in comps],
                            np.int32)
            ptrs = (ctypes.c_void_p * ns)(*[frame.samples[i].ctypes.data
                                            for i in comps])
            n = lib.fx_lossless_scan(ns, ptrs, geom.ctypes.data,
                                     frame.lmcux, frame.lmcuy, ss, al,
                                     restart, dc_tabs.ctypes.data,
                                     buf.ctypes.data, cap)
        else:
            geom = np.array([[*frame.geom[i][:5], frame.tables[i],
                              frame.tables[i]] for i in comps], np.int32)
            ptrs = (ctypes.c_void_p * ns)(*[frame.coef[i].ctypes.data
                                            for i in comps])
            if coding == "huffman":
                n = lib.fx_huff_scan(int(progressive), ns, ptrs,
                                     geom.ctypes.data, frame.mcux,
                                     frame.mcuy, ss, se, ah, al, restart,
                                     dc_tabs.ctypes.data,
                                     ac_tabs.ctypes.data, buf.ctypes.data,
                                     cap)
            else:
                n = lib.fx_arith_scan(int(progressive), ns, ptrs,
                                      geom.ctypes.data, frame.mcux,
                                      frame.mcuy, ss, se, ah, al, restart,
                                      luk.ctypes.data, buf.ctypes.data, cap)
        if n == 0:
            raise RuntimeError("JPEG fixture coder: out of room or memory")
        sos = bytes([ns]) + b"".join(
            bytes([ids[i], 0 if lossless else (frame.tables[i] << 4)
                   | frame.tables[i]]) for i in comps) + bytes(
            [ss, se, (ah << 4) | al])
        out.append(_segment(0xDA, sos))
        out.append(buf[:n].tobytes())
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img, *, quality=90, sampling=None, colour=None,
               **kw) -> bytes:
    """Write `img` as a JPEG in the given mode (the module's docstring
    names the options); returns the file's bytes."""
    data = encode(Frame(img, quality, sampling, colour), **kw)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data
