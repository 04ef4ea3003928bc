"""Depth -> point cloud, in numpy (port of
google_nerf_tpu/depth/pointcloud.py; the reference's
`Minist_Test/lib/test_utils.py` reconstruct_3D:131, save_point_cloud:164
and `Train/tools/utils.py` reconstruct_depth:89).  PLY files are binary
little-endian or ASCII, float xyz and uchar rgb per vertex.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def reconstruct_3d(depth: np.ndarray, f: float,
                   u0: Optional[float] = None,
                   v0: Optional[float] = None) -> np.ndarray:
    """depth (H, W) -> points (H*W, 3); pinhole with principal point at
    the image centre unless given (`test_utils.py:131-160`)."""
    h, w = depth.shape
    u0 = w / 2.0 if u0 is None else u0
    v0 = h / 2.0 if v0 is None else v0
    u = np.arange(w) - u0
    v = np.arange(h) - v0
    x = depth * u[None, :] / f
    y = depth * v[:, None] / f
    return np.stack([x, y, depth], -1).reshape(-1, 3)


def save_point_cloud(points: np.ndarray, rgb: Optional[np.ndarray],
                     path: str, binary: bool = True) -> None:
    """Write an ASCII/binary PLY (`test_utils.py:164-196`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = points.shape[0]
    if rgb is None:
        rgb = np.full((n, 3), 255, np.uint8)
    rgb = np.asarray(rgb).reshape(-1, 3).astype(np.uint8)
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary
           else "format ascii 1.0\n")
        + f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    if binary:
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = points.astype(np.float32)
        rec["rgb"] = rgb
        with open(path, "wb") as fh:
            fh.write(header.encode())
            rec.tofile(fh)
    else:
        with open(path, "w") as fh:
            fh.write(header)
            for p, c in zip(points, rgb):
                fh.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def reconstruct_depth(depth: np.ndarray, rgb: Optional[np.ndarray],
                      out_dir: str, name: str, focal: float) -> str:
    """Clip + reconstruct + save PLY (`Train/tools/utils.py:89-105`)."""
    depth = np.squeeze(depth)
    mask = depth < 1e-8
    depth = np.where(mask, 0.0, depth)
    points = reconstruct_3d(depth, focal)
    path = os.path.join(out_dir, f"{name}.ply")
    save_point_cloud(points, rgb.reshape(-1, 3) if rgb is not None else None,
                     path)
    return path
