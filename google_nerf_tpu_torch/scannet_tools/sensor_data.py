"""ScanNet `.sens` reader (format v4), exporters and writer (port of
google_nerf_tpu/scannet_tools/sensor_data.py).

The header is parsed from a memory-mapped file when the reader opens it,
the frames lazily: `iter_frames` walks them, `frame(i)` reads one
through an offset index built on first use.  Depth frames are zlib
streams of uint16 (decompressed by scannet_tools.native), colour frames
JPEGs.  The exporters write what JAX's write, through the port's image
code where JAX's go through imageio and cv2: depth as 16-bit gray PNGs
(write_png), colour as JPEGs at Pillow's default quality, 75, which is
what imageio writes (write_jpeg), both resized with cv2's INTER_NEAREST
positions (resize_nearest), and poses and intrinsics as text.
"""
from __future__ import annotations

import dataclasses
import mmap
import os
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from google_nerf_tpu_torch.scannet_tools import native
from google_nerf_tpu_torch.utils.image import (decode_jpeg, resize_nearest,
                                               write_jpeg, write_png)

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                          2: "occi_ushort"}
JPEG_QUALITY = 75       # Pillow's default, at which imageio writes JPEGs


@dataclasses.dataclass
class RGBDFrame:
    camera_to_world: np.ndarray  # (4, 4) float32
    timestamp_color: int
    timestamp_depth: int
    color_data: bytes            # compressed (jpeg)
    depth_data: bytes            # compressed (zlib)

    def decompress_depth(self, compression_type: str) -> bytes:
        if compression_type != "zlib_ushort":
            raise ValueError(f"invalid depth compression {compression_type}")
        return native.zlib_decompress(self.depth_data)

    def decompress_color(self, compression_type: str) -> np.ndarray:
        if compression_type != "jpeg":
            raise ValueError(f"invalid color compression {compression_type}")
        return decode_jpeg(self.color_data)

    def depth_image(self, compression_type: str, height: int,
                    width: int) -> np.ndarray:
        return np.frombuffer(self.decompress_depth(compression_type),
                             dtype=np.uint16).reshape(height, width)


class SensorData:
    """Parses the header when opened, the frames lazily (`iter_frames`
    walks them, `frame(i)` reads one through an offset index built on
    first use)."""

    VERSION = 4

    def __init__(self, filename: str):
        self.filename = filename
        self._file = open(filename, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty/special files
            self._buf = self._file.read()
        self._parse_header()
        self._offsets: Optional[list] = None

    def _parse_header(self):
        buf = self._buf
        off = 0

        def take(fmt):
            nonlocal off
            size = struct.calcsize(fmt)
            vals = struct.unpack_from(fmt, buf, off)
            off += size
            return vals if len(vals) > 1 else vals[0]

        version = take("<I")
        if version != self.VERSION:
            raise ValueError(f"unsupported .sens version {version}")
        strlen = take("<Q")
        self.sensor_name = bytes(buf[off:off + strlen])
        off += strlen
        mats = []
        for _ in range(4):
            mats.append(np.array(take("<16f"), np.float32).reshape(4, 4))
        (self.intrinsic_color, self.extrinsic_color,
         self.intrinsic_depth, self.extrinsic_depth) = mats
        self.color_compression_type = COMPRESSION_TYPE_COLOR[take("<i")]
        self.depth_compression_type = COMPRESSION_TYPE_DEPTH[take("<i")]
        self.color_width = take("<I")
        self.color_height = take("<I")
        self.depth_width = take("<I")
        self.depth_height = take("<I")
        self.depth_shift = take("<f")
        self.num_frames = take("<Q")
        self._frames_start = off

    _FRAME_FIXED = struct.Struct("<16f4Q")

    def _read_frame_at(self, off: int):
        vals = self._FRAME_FIXED.unpack_from(self._buf, off)
        c2w = np.array(vals[:16], np.float32).reshape(4, 4)
        ts_c, ts_d, csize, dsize = vals[16:]
        off += self._FRAME_FIXED.size
        color = bytes(self._buf[off:off + csize])
        off += csize
        depth = bytes(self._buf[off:off + dsize])
        off += dsize
        return RGBDFrame(c2w, ts_c, ts_d, color, depth), off

    def iter_frames(self) -> Iterator[RGBDFrame]:
        off = self._frames_start
        for _ in range(self.num_frames):
            frame, off = self._read_frame_at(off)
            yield frame

    def _build_index(self):
        if self._offsets is not None:
            return
        self._offsets = []
        off = self._frames_start
        for _ in range(self.num_frames):
            self._offsets.append(off)
            vals = self._FRAME_FIXED.unpack_from(self._buf, off)
            off += self._FRAME_FIXED.size + vals[18] + vals[19]

    def frame(self, i: int) -> RGBDFrame:
        self._build_index()
        return self._read_frame_at(self._offsets[i])[0]

    @property
    def frames(self):
        """Materialised frame list (the reference's API)."""
        return list(self.iter_frames())

    def close(self):
        if isinstance(self._buf, mmap.mmap):
            self._buf.close()
        self._file.close()

    # -- exporters (the reference's SensorData.py:76-120) ----------------

    @staticmethod
    def _save_mat(matrix: np.ndarray, path: str):
        with open(path, "w") as f:
            for row in matrix:
                f.write(" ".join(f"{v:f}" for v in row) + "\n")

    def export_depth_images(self, output_path, image_size=None,
                            frame_skip=1):
        """Every frame_skip-th depth frame -> <i>.png, 16-bit gray, resized
        to image_size = (h, w) with cv2's INTER_NEAREST positions."""
        os.makedirs(output_path, exist_ok=True)
        for i, frame in enumerate(self.iter_frames()):
            if i % frame_skip:
                continue
            depth = frame.depth_image(self.depth_compression_type,
                                      self.depth_height, self.depth_width)
            if image_size is not None:
                depth = resize_nearest(depth.astype(np.int32),
                                       (image_size[1], image_size[0]))
                depth = depth.numpy().astype(np.uint16)
            write_png(os.path.join(output_path, f"{i}.png"), depth)

    def export_color_images(self, output_path, image_size=None,
                            frame_skip=1):
        """Every frame_skip-th colour frame -> <i>.jpg at JPEG_QUALITY,
        resized to image_size = (h, w) with cv2's INTER_NEAREST
        positions."""
        os.makedirs(output_path, exist_ok=True)
        for i, frame in enumerate(self.iter_frames()):
            if i % frame_skip:
                continue
            color = frame.decompress_color(self.color_compression_type)
            if image_size is not None:
                color = resize_nearest(color, (image_size[1],
                                               image_size[0])).numpy()
            write_jpeg(os.path.join(output_path, f"{i}.jpg"), color,
                       quality=JPEG_QUALITY)

    def export_poses(self, output_path, frame_skip=1):
        os.makedirs(output_path, exist_ok=True)
        for i, frame in enumerate(self.iter_frames()):
            if i % frame_skip:
                continue
            self._save_mat(frame.camera_to_world,
                           os.path.join(output_path, f"{i}.txt"))

    def export_intrinsics(self, output_path):
        os.makedirs(output_path, exist_ok=True)
        self._save_mat(self.intrinsic_color,
                       os.path.join(output_path, "intrinsic_color.txt"))
        self._save_mat(self.extrinsic_color,
                       os.path.join(output_path, "extrinsic_color.txt"))
        self._save_mat(self.intrinsic_depth,
                       os.path.join(output_path, "intrinsic_depth.txt"))
        self._save_mat(self.extrinsic_depth,
                       os.path.join(output_path, "extrinsic_depth.txt"))


def write_sens(path: str, *, sensor_name: bytes = b"synthetic",
               intrinsic_color=None, intrinsic_depth=None,
               color_wh=(8, 6), depth_wh=(8, 6), depth_shift=1000.0,
               frames=()):
    """Write a v4 .sens file.  `frames` is a sequence of (c2w (4, 4),
    color_jpeg_bytes, depth_uint16 (h, w)); colour is marked jpeg, depth
    zlib_ushort."""
    eye = np.eye(4, dtype=np.float32)
    intr_c = eye if intrinsic_color is None else intrinsic_color
    intr_d = eye if intrinsic_depth is None else intrinsic_depth
    with open(path, "wb") as f:
        f.write(struct.pack("<I", SensorData.VERSION))
        f.write(struct.pack("<Q", len(sensor_name)))
        f.write(sensor_name)
        for m in (intr_c, eye, intr_d, eye):
            f.write(np.asarray(m, np.float32).tobytes())
        f.write(struct.pack("<ii", 2, 1))  # jpeg, zlib_ushort
        f.write(struct.pack("<IIII", color_wh[0], color_wh[1],
                            depth_wh[0], depth_wh[1]))
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", len(frames)))
        for c2w, jpg, depth in frames:
            f.write(np.asarray(c2w, np.float32).tobytes())
            dz = zlib.compress(np.asarray(depth, np.uint16).tobytes())
            f.write(struct.pack("<QQQQ", 0, 0, len(jpg), len(dz)))
            f.write(jpg)
            f.write(dz)
