"""Image decode of ``packnet_sfm_tpu/datasets/kitti.py``: ``load_image_u8``
and ``load_image`` only, through Pillow (imported where it is used). The
KITTI dataset itself and the native decode wait for the data (ROADMAP.md
§1 item 11)."""

from __future__ import annotations

import numpy as np


def load_image_u8(path: str) -> np.ndarray:
    """RGB image as uint8 [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_image(path: str) -> np.ndarray:
    """RGB image as float32 [H, W, 3] in [0, 1]."""
    return load_image_u8(path).astype(np.float32) / 255.0
