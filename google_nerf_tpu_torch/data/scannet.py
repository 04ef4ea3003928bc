"""ScanNet dataset with the fork's debugged pose conventions (port of
google_nerf_tpu/data/scannet.py; these must be kept as they are or PSNR
silently collapses):

  * scene AABB from the raw scan's `_vh_clean_2.ply` vertices;
    scale = (max-min).max()/2 * 1.05, shift = center
  * intrinsics from `intrinsic_depth.txt`, image size 640x480 *
    downsample, K NOT rescaled
  * directions via get_ray_directions_scannet (no axis flips)
  * split files `test_step_{test_skip}/{split}.txt` of frame ids
  * optional rot_transpose / scale_flip pose fixes
  * pose translation: (t - shift) / (2*scale) -> scene in [-0.5, 0.5]^3

The raw-scan root is a kwarg (DEFAULT_RAW_SCAN_ROOT, then root_dir, are
searched after it); `depth_dir` loads per-frame depth priors (.npy in
metres, or 16-bit PNGs in mm as `<id>-depth_raw.png` or `<id>.png`),
nearest-resized to the image and divided by 2*scale, for the depth loss.
Colour frames are JPEGs, decoded by the port's reader and resized with
cv2.resize's bilinear sample positions.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from google_nerf_tpu_torch.core.rays import get_ray_directions_scannet
from google_nerf_tpu_torch.data.base import BaseDataset
from google_nerf_tpu_torch.data.loaders import resize_to
from google_nerf_tpu_torch.data.ply import read_ply_vertices
from google_nerf_tpu_torch.utils.image import read_image

DEFAULT_RAW_SCAN_ROOT = "/orion/group/scannet_v2/scans/"


class ScannetDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, *,
                 test_skip: int = 10, rot_transpose: bool = False,
                 scale_flip: bool = False, raw_scan_rootdir: str = None,
                 depth_dir: str = None, device="cuda", **kwargs):
        super().__init__(root_dir, split, downsample, device)
        scenename = os.path.basename(os.path.normpath(root_dir))

        ply_path = None
        for root in filter(None, [raw_scan_rootdir, DEFAULT_RAW_SCAN_ROOT,
                                  root_dir]):
            cand = os.path.join(root, scenename, scenename
                                + "_vh_clean_2.ply")
            cand2 = os.path.join(root, scenename + "_vh_clean_2.ply")
            if os.path.exists(cand):
                ply_path = cand
                break
            if os.path.exists(cand2):
                ply_path = cand2
                break
        if ply_path is None:
            raise FileNotFoundError(
                f"{scenename}_vh_clean_2.ply not found (searched raw scan "
                f"roots); pass raw_scan_rootdir=")
        vertices = read_ply_vertices(ply_path)
        xyz_min = vertices.min(0)
        xyz_max = vertices.max(0)
        self.shift = (xyz_max + xyz_min) / 2
        self.scale = (xyz_max - xyz_min).max() / 2 * 1.05

        K = np.loadtxt(os.path.join(root_dir, "intrinsic_depth.txt"),
                       dtype=np.float32)[:3, :3]
        w, h = int(640 * downsample), int(480 * downsample)
        self.K = K
        self.directions = get_ray_directions_scannet(
            h, w, K, device="cpu").numpy()
        self.img_wh = (w, h)
        self.test_skip = test_skip
        self.depth_dir = depth_dir
        self.read_meta(split, rot_transpose=rot_transpose,
                       scale_flip=scale_flip)

    def read_meta(self, split, rot_transpose=False, scale_flip=False):
        filename = os.path.join(self.root_dir,
                                f"test_step_{self.test_skip}", f"{split}.txt")
        with open(filename) as f:
            lines = [line.rstrip() for line in f]

        print(f"Loading {len(lines)} {split} images ...")
        poses = []
        for line in lines:
            c2w = np.loadtxt(
                os.path.join(self.root_dir, "pose", line + ".txt"))
            c2w = c2w.reshape(4, 4)[:3]
            if rot_transpose:
                c2w[:, :3] = c2w[:, :3].T
            if scale_flip:
                c2w[:3, 1] *= -1
                c2w[:3, 2] *= -1
            c2w[:, 3] -= self.shift
            c2w[:, 3] /= 2 * self.scale
            poses.append(c2w)

        def frame(line):
            img = read_image(os.path.join(self.root_dir, "rgb",
                                          line + ".jpg")
                             ).astype(np.float32) / 255.0
            img = resize_to(img, self.img_wh).reshape(-1, 3)
            dp = (self._read_depth_prior(line)
                  if self.depth_dir is not None else None)
            return img, dp

        with ThreadPoolExecutor(max_workers=min(16, max(len(lines), 1))
                                ) as pool:
            frames = list(pool.map(frame, lines))
        self.rays = np.stack([f[0] for f in frames]).astype(np.float32)
        self.poses = np.stack(poses).astype(np.float32)
        if self.depth_dir is not None:
            self.depths = np.stack([f[1] for f in frames]).astype(np.float32)

    def _read_depth_prior(self, frame_id: str) -> np.ndarray:
        """Load a monocular depth prior for one frame as a flat (h*w,) array
        in *scene units* (normalized by 2*scale like the poses)."""
        for ext, scale in ((".npy", 1.0), ("-depth_raw.png", 1 / 1000.0),
                           (".png", 1 / 1000.0)):
            p = os.path.join(self.depth_dir, frame_id + ext)
            if os.path.exists(p):
                if ext == ".npy":
                    d = np.load(p).astype(np.float32) * scale
                else:
                    d = read_image(p).astype(np.float32) * scale
                d = resize_to(d, self.img_wh, nearest=True)
                return (d / (2 * self.scale)).reshape(-1)
        raise FileNotFoundError(
            f"no depth prior for frame {frame_id} in {self.depth_dir}")
