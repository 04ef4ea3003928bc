"""Surface normals from depth, for the PWN losses (port of
google_nerf_tpu/depth/normals.py; the reference's
`Train/lib/models/Surface_normal.py:1-213`):

  * `depth_to_xyz`: unproject with the principal point at the image
    centre;
  * `get_surface_normal_v2`: cross products of the horizontal and
    vertical differences at two offsets (the patch edge and one pixel
    in), averaged and oriented towards the camera
    (`Surface_normal.py:96-157`);
  * `surface_normal_from_depth`: two 3x3 box blurs, then normals
    (`Surface_normal.py:159-177`).

Layout: depth maps are (B, H, W); xyz and normals are NCHW, (B, 3, H, W).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F


def depth_to_xyz(depth: torch.Tensor, focal_length: torch.Tensor
                 ) -> torch.Tensor:
    """depth (B, H, W), focal_length (B,) -> xyz (B, 3, H, W): the
    pinhole unprojection with the principal point at (W/2, H/2)
    (`Surface_normal.py:6-30`)."""
    b, h, w = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device) - w / 2.0
    v = torch.arange(h, dtype=depth.dtype, device=depth.device) - h / 2.0
    f = focal_length.to(depth.dtype).reshape(b, 1, 1)
    x = u[None, None, :] * depth / f
    y = v[None, :, None] * depth / f
    return torch.stack([x, y, depth], dim=1)


def box_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) 3x3 mean with zero padding (avg_pool2d's
    count_include_pad, as `Surface_normal.py:163-164`)."""
    return F.avg_pool2d(img[:, None], 3, 1, 1,
                        count_include_pad=True)[:, 0]


def _orient(n: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    flip = (n * xyz).sum(1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def _unit(n: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return n / (torch.linalg.vector_norm(n, dim=1, keepdim=True) + eps)


def get_surface_normal_v2(xyz: torch.Tensor, patch_size: int = 5
                          ) -> torch.Tensor:
    """xyz (B, 3, H, W) -> unit normals (B, 3, H, W)
    (`Surface_normal.py:96-157`)."""
    h, w = xyz.shape[-2:]
    half = patch_size // 2
    xp = F.pad(xyz, (half, half, half, half))
    rows = slice(half, half + h)
    cols = slice(half, half + w)
    # the outer differences (offset half a patch) and the inner ones (the
    # window's edges one pixel in)
    horiz = xp[..., rows, :w] - xp[..., rows, -w:]
    vert = xp[..., :h, cols] - xp[..., -h:, cols]
    horiz_in = (xp[..., rows, 1:w + 1]
                - xp[..., rows, patch_size - 1:patch_size - 1 + w])
    vert_in = (xp[..., 1:h + 1, cols]
               - xp[..., patch_size - 1:patch_size - 1 + h, cols])
    n1 = _unit(_orient(torch.linalg.cross(horiz_in, vert_in, dim=1), xyz))
    n2 = _unit(_orient(torch.linalg.cross(horiz, vert, dim=1), xyz))
    return _orient(_unit(n1 + n2), xyz)


def surface_normal_from_depth(depth: torch.Tensor,
                              focal_length: torch.Tensor,
                              valid_mask: torch.Tensor = None
                              ) -> torch.Tensor:
    """depth (B, H, W), focal_length (B,), valid_mask (B, H, W) bool ->
    normals (B, 3, H, W), zero off the mask (`Surface_normal.py:159-177`)."""
    d = box_blur_3x3(box_blur_3x3(depth))
    n = get_surface_normal_v2(depth_to_xyz(d, focal_length))
    if valid_mask is not None:
        n = torch.where(valid_mask[:, None], n, torch.zeros_like(n))
    return n
