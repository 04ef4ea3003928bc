"""Minimal PLY IO: vertex reading (ascii and binary) and point-cloud
writing (port of google_nerf_tpu/data/ply.py; the ScanNet loader takes
the scene AABB from `_vh_clean_2.ply` with it)."""
from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """Returns the (N, 3) xyz vertex array of a PLY file."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype), ...])
        cur = None
        while True:
            line = f.readline().strip().decode("ascii", errors="replace")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment") or line.startswith("obj_info"):
                continue
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append((parts[-1], "list",
                                   _TYPES[parts[2]], _TYPES[parts[3]]))
                else:
                    cur[2].append((parts[2], _TYPES[parts[1]]))
            elif line == "end_header":
                break

        for name, cnt, props in elements:
            if name == "vertex":
                if any(len(p) > 2 for p in props):
                    raise ValueError("list property in vertex element")
                dtype = np.dtype([(p[0], ("<" if fmt != "binary_big_endian"
                                          else ">") + p[1])
                                  for p in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(cnt)]
                    data = np.array([[float(v) for v in r[:len(props)]]
                                     for r in rows])
                    return data[:, :3].astype(np.float32)
                data = np.frombuffer(f.read(cnt * dtype.itemsize),
                                     dtype=dtype, count=cnt)
                return np.stack([data["x"], data["y"], data["z"]],
                                -1).astype(np.float32)
            # skip non-vertex elements that precede vertex (rare)
            if fmt == "ascii":
                for _ in range(cnt):
                    f.readline()
            else:
                raise ValueError(
                    "binary PLY with non-vertex element before vertex")
    raise ValueError(f"no vertex element in {path}")


def save_point_cloud(path: str, xyz: np.ndarray, rgb=None):
    """Write an (N, 3) point cloud (+ optional (N, 3) uint8 colors) as
    binary_little_endian PLY."""
    n = len(xyz)
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if rgb is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.empty(n, dtype=np.dtype(props))
    arr["x"], arr["y"], arr["z"] = xyz.T.astype(np.float32)
    if rgb is not None:
        arr["red"], arr["green"], arr["blue"] = rgb.T.astype(np.uint8)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {a}" for a in "xyz"]
        if rgb is not None:
            header += [f"property uchar {c}"
                       for c in ("red", "green", "blue")]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        f.write(arr.tobytes())
