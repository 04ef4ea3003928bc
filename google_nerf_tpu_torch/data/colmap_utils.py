"""COLMAP binary model reader: cameras/images/points3D .bin (port of
google_nerf_tpu/data/colmap_utils.py; format spec:
https://colmap.github.io/format.html)."""
from __future__ import annotations

import collections
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["id", "name", "num_params"])
Camera = collections.namedtuple("Camera", ["id", "model", "width", "height",
                                           "params"])
BaseImage = collections.namedtuple("Image", ["id", "qvec", "tvec",
                                             "camera_id", "name", "xys",
                                             "point3D_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error",
                                             "image_ids", "point2D_idxs"])

_CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
_MODEL_BY_ID = {m.id: m for m in _CAMERA_MODELS}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    tr = np.trace(R)
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], tr]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            model = _MODEL_BY_ID[model_id]
            params = np.array(_read(f, "<" + "d" * model.num_params))
            cameras[cam_id] = Camera(cam_id, model.name, w, h, params)
    return cameras


class Image(BaseImage):
    """Image record with the qvec2rotmat method of the vendored reader."""

    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            im_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            data = np.fromfile(f, "<f8", int(n2d) * 3).reshape(-1, 3)
            xys = data[:, :2]
            p3d_ids = data[:, 2].astype(np.int64)
            images[im_id] = Image(im_id, qvec, tvec, cam_id,
                                  name.decode("utf-8"), xys, p3d_ids)
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<ddd"))
            rgb = np.array(_read(f, "<BBB"))
            (err,) = _read(f, "<d")
            (tlen,) = _read(f, "<Q")
            track = np.fromfile(f, "<i4", int(tlen) * 2).reshape(-1, 2)
            points[pid] = Point3D(pid, xyz, rgb, err,
                                  track[:, 0], track[:, 1])
    return points
