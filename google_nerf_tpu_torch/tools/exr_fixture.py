"""An OpenEXR writer for fixtures: single-part scanline files, written
from the OpenEXR file-layout specification with numpy and zlib alone.

It shares no code with the port's reader (csrc/image_codec.c), so a
file it writes that the reader gives back bit for bit checks both
against the specification rather than against each other.

    write_exr(path, img, compression="ZIP", pixel_type="HALF")

img: (H, W) -> channel Y; (H, W, 3) -> R, G, B; (H, W, 4) -> R, G, B, A;
or a dict {channel name: (H, W) array}.  Channels are stored in
alphabetical order, as OpenEXR stores them.  compression: "NO", "RLE",
"ZIPS" or "ZIP"; pixel_type: "HALF" or "FLOAT", or a dict of one per
channel; line_order: "INCREASING_Y" or "DECREASING_Y" (the order of the
chunks in the file); origin: the data window's (xMin, yMin).  A chunk
whose compressed form is not smaller than its raw bytes is stored raw,
as the specification asks.

chip_smoke.py writes its RTMV scene's frames with it; the tests write
their OpenEXR cases with it.
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAGIC = 20000630
COMPRESSION = {"NO": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3}
LINES_PER_CHUNK = {"NO": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16}
PIXEL_TYPE = {"HALF": (1, "<f2"), "FLOAT": (2, "<f4")}
LINE_ORDER = {"INCREASING_Y": 0, "DECREASING_Y": 1}


def _attr(name: str, type_name: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + type_name.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def _channels(img) -> dict:
    if isinstance(img, dict):
        return {k: np.asarray(v) for k, v in img.items()}
    img = np.asarray(img)
    if img.ndim == 2:
        return {"Y": img}
    if img.ndim == 3 and img.shape[2] in (3, 4):
        return dict(zip("RGBA", np.moveaxis(img, -1, 0)))
    raise ValueError(f"write_exr takes (H, W), (H, W, 3|4) or a dict of "
                     f"channels, got {img.shape}")


def _predict(raw: bytes) -> bytes:
    """The ZIP and RLE filters: the even bytes, then the odd bytes, then
    each byte as its difference from the one before plus 128."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]])
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + np.uint8(128)
    return d.tobytes()


def _rle(data: bytes) -> bytes:
    """Runs of 3 to 128 equal bytes as (count - 1, byte); everything else
    as literal runs of up to 127 bytes, (-count, bytes...)."""
    out, lit, i, n = bytearray(), bytearray(), 0, len(data)

    def flush():
        while lit:
            k = min(len(lit), 127)
            out.append((-k) & 255)
            out.extend(lit[:k])
            del lit[:k]

    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes((j - i - 1, data[i]))
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _pack(raw: bytes, compression: str) -> bytes:
    if compression == "NO":
        return raw
    filtered = _predict(raw)
    packed = (_rle(filtered) if compression == "RLE"
              else zlib.compress(filtered, 4))
    return packed if len(packed) < len(raw) else raw


def write_exr(path: str, img, *, compression: str = "ZIP",
              pixel_type="HALF", line_order: str = "INCREASING_Y",
              origin=(0, 0)) -> None:
    chans = _channels(img)
    names = sorted(chans)
    h, w = chans[names[0]].shape
    types = (pixel_type if isinstance(pixel_type, dict)
             else {k: pixel_type for k in names})
    x0, y0 = origin
    box = struct.pack("<iiii", x0, y0, x0 + w - 1, y0 + h - 1)
    chlist = b"".join(k.encode() + b"\0" + struct.pack(
        "<iB3xii", PIXEL_TYPE[types[k]][0], 0, 1, 1) for k in names) + b"\0"
    header = b"".join([
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression",
              bytes([COMPRESSION[compression]])),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", bytes([LINE_ORDER[line_order]])),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\0"
    # each scanline: every channel's w samples in turn, little-endian
    planes = [np.ascontiguousarray(chans[k].astype(PIXEL_TYPE[types[k]][1]))
              .view(np.uint8).reshape(h, -1) for k in names]
    lines = np.concatenate(planes, 1)
    lpc = LINES_PER_CHUNK[compression]
    starts = list(range(0, h, lpc))
    with ThreadPoolExecutor(max_workers=8) as pool:   # zlib frees the GIL
        packed = list(pool.map(
            lambda s: _pack(lines[s:s + lpc].tobytes(), compression),
            starts))
    order = range(len(starts))
    if line_order == "DECREASING_Y":
        order = reversed(order)
    pos = 8 + len(header) + 8 * len(starts)
    offsets, body = [0] * len(starts), []
    for i in order:
        offsets[i] = pos
        body.append(struct.pack("<ii", y0 + starts[i], len(packed[i])))
        body.append(packed[i])
        pos += 8 + len(packed[i])
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        f.writelines(body)
