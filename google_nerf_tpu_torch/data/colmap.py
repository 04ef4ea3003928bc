"""COLMAP-reconstruction dataset (port of google_nerf_tpu/data/colmap.py).

Binary model parsing, point-cloud centering, min-camera-norm scaling,
the every-8th-image test split and the spheric fly-through trajectory,
with one batched quaternion->R conversion for all images and the shared
parallel image loader.
"""
from __future__ import annotations

import os

import numpy as np

from google_nerf_tpu_torch.core.rays import center_poses, create_spheric_poses
from google_nerf_tpu_torch.data.base import BaseDataset, directions_of
from google_nerf_tpu_torch.data.colmap_utils import (read_cameras_binary,
                                                     read_images_binary,
                                                     read_points3d_binary)
from google_nerf_tpu_torch.data.loaders import load_image_stack

# camera model -> (fx, fy, cx, cy) parameter indices
_CAM_PARAM_IDX = {"SIMPLE_RADIAL": (0, 0, 1, 2),
                  "SIMPLE_PINHOLE": (0, 0, 1, 2),
                  "PINHOLE": (0, 1, 2, 3),
                  "OPENCV": (0, 1, 2, 3)}


def _quats_to_rotmats(qvecs: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz quaternions -> (N, 3, 3), batched."""
    w, x, y, z = (qvecs[:, i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0,
                 device="cuda", **kwargs):
        super().__init__(root_dir, split, downsample, device)
        sparse = os.path.join(root_dir, "sparse/0")

        cam = read_cameras_binary(os.path.join(sparse, "cameras.bin"))[1]
        if cam.model not in _CAM_PARAM_IDX:
            raise ValueError(f"unsupported COLMAP camera model {cam.model}")
        ds = downsample
        w, h = int(cam.width * ds), int(cam.height * ds)
        ifx, ify, icx, icy = _CAM_PARAM_IDX[cam.model]
        self.K = np.float32([[cam.params[ifx] * ds, 0, cam.params[icx] * ds],
                             [0, cam.params[ify] * ds, cam.params[icy] * ds],
                             [0, 0, 1]])
        self.img_wh = (w, h)
        self.directions = directions_of(h, w, self.K)

        # w2c -> c2w for all images at once, name-sorted
        imdata = read_images_binary(os.path.join(sparse, "images.bin"))
        ims = sorted(imdata.values(), key=lambda im: im.name)
        R = _quats_to_rotmats(np.stack([im.qvec for im in ims]))
        t = np.stack([im.tvec for im in ims])[..., None]
        c2w_R = np.swapaxes(R, 1, 2)
        c2w_t = -c2w_R @ t
        poses = np.concatenate([c2w_R, c2w_t], -1)        # (N, 3, 4)

        pts = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        pts3d = np.stack([p.xyz for p in pts.values()])

        self.poses, self.pts3d = center_poses(poses, pts3d)
        norm = np.linalg.norm(self.poses[..., 3], axis=-1).min()
        self.poses = np.array(self.poses, np.float32)
        self.poses[..., 3] /= norm
        self.pts3d = self.pts3d / norm

        if split == "test_traj":
            self.poses = create_spheric_poses(
                1.2, self.poses[:, 1, 3].mean()).astype(np.float32)
            return

        folder = (f"images_{int(1 / ds)}"
                  if "360_v2" in root_dir and ds < 1 else "images")
        paths = np.asarray([os.path.join(root_dir, folder, im.name)
                            for im in ims])
        idx = np.arange(len(paths))
        keep = {"train": idx[idx % 8 != 0],
                "test": idx[idx % 8 == 0]}.get(split, idx)
        self.poses = np.ascontiguousarray(self.poses[keep], np.float32)
        print(f"Loading {len(keep)} {split} images ...")
        self.rays = load_image_stack(list(paths[keep]), self.img_wh)
