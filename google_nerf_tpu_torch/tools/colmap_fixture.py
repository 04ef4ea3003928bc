"""A COLMAP binary model writer for fixtures: sparse/0/cameras.bin,
images.bin and points3D.bin as COLMAP writes them
(https://colmap.github.io/format.html), with struct alone; the frames
are the caller's.

    write_model(root + "/sparse/0", cameras, images, points)

cameras: [(camera_id, model_id, width, height, params)] (model 1 is
PINHOLE: fx, fy, cx, cy); images: [(image_id, qvec (w, x, y, z), tvec,
camera_id, name, [(x, y, point3D_id), ...])], the world-to-camera
rotation and translation; points: [(point3D_id, xyz, rgb, error,
[(image_id, point2D_idx), ...])].  w2c_of turns an OpenCV camera-to-world
pose into (qvec, tvec).

chip_smoke.py writes its COLMAP scene with it; tests/test_torch_loaders.py
writes its COLMAP fixtures with it.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from google_nerf_tpu_torch.data.colmap_utils import rotmat2qvec


def w2c_of(c2w):
    """A (3, 4) or (4, 4) OpenCV camera-to-world pose -> COLMAP's
    world-to-camera (qvec, tvec)."""
    c2w = np.asarray(c2w, np.float64)
    R = c2w[:3, :3].T
    return rotmat2qvec(R), -R @ c2w[:3, 3]


def write_model(sparse, cameras, images, points):
    """The three .bin files of a COLMAP model into the folder `sparse`
    (made if missing)."""
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, model_id, w, h, params in cameras:
            f.write(struct.pack("<iiQQ", cam_id, model_id, w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for image_id, qvec, tvec, cam_id, name, pts2d in images:
            f.write(struct.pack("<i", image_id))
            f.write(struct.pack("<dddd", *qvec))
            f.write(struct.pack("<ddd", *tvec))
            f.write(struct.pack("<i", cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(pts2d)))
            for x, y, pid in pts2d:
                f.write(struct.pack("<ddq", x, y, pid))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, xyz, rgb, error, track in points:
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<ddd", *xyz))
            f.write(struct.pack("<BBB", *rgb))
            f.write(struct.pack("<d", error))
            f.write(struct.pack("<Q", len(track)))
            for image_id, idx in track:
                f.write(struct.pack("<ii", image_id, idx))
