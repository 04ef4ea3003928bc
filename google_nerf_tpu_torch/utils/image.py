"""Image output with the standard library alone: 8-bit RGB PNGs (zlib +
struct) and depth maps through a 256-entry Turbo colour table."""
from __future__ import annotations

import struct
import zlib

import numpy as np

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


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, every row unfiltered."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], 1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
