"""Colour-space helpers and the single-image reader (port of
google_nerf_tpu/data/color_utils.py; the implementations live in
data/loaders.py)."""
from __future__ import annotations

import numpy as np

from google_nerf_tpu_torch.data.loaders import (decode_image, linear_to_srgb,
                                                srgb_to_linear)

__all__ = ["srgb_to_linear", "linear_to_srgb", "read_image"]


def read_image(img_path: str, img_wh, blend_a: bool = True) -> np.ndarray:
    """One image -> (h*w, 3) float32 in [0, 1]; RGBA composes onto white
    (blend_a) or black."""
    return decode_image(img_path, img_wh, alpha_bg=1.0 if blend_a else 0.0)
