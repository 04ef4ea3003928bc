"""PFM depth map reader and writer (port of
google_nerf_tpu/data/depth_utils.py)."""
from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    """Returns (data, scale). data is (H, W[, 3]) float, bottom-up flipped."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")
        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("ascii"))
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0):
    """Inverse of read_pfm (little-endian)."""
    data = np.flipud(data).astype(np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())
        data.tofile(f)
