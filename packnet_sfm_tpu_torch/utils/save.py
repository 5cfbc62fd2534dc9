"""Depth map writers and readers: the port's own copy of
``packnet_sfm_tpu/utils/save.py`` (same files for the same arrays). PNG goes
through Pillow, imported where it is used."""

from __future__ import annotations

import os

import numpy as np


def write_depth(filename: str, depth: np.ndarray, intrinsics=None):
    """Save a [H, W] depth map as .npz (with intrinsics) or 16-bit .png x256."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    if filename.endswith(".npz"):
        np.savez_compressed(filename, depth=depth, intrinsics=intrinsics)
    elif filename.endswith(".png"):
        from PIL import Image
        arr = (np.asarray(depth, np.float64) * 256.0).astype(np.int32)
        Image.fromarray(arr, mode="I").save(filename)
    else:
        raise NotImplementedError(f"Depth filename not valid: {filename}")


def load_depth(file: str) -> np.ndarray:
    """Load a [H, W] depth map from .npz or x256 .png (invalid pixels are 0)."""
    if file.endswith("npz"):
        return np.load(file)["depth"]
    if file.endswith("png"):
        from PIL import Image
        depth_png = np.asarray(Image.open(file), dtype=np.int64)
        if depth_png.max() <= 255:
            raise ValueError(f"{file}: not a x256 depth png")
        return depth_png.astype(np.float32) / 256.0
    raise NotImplementedError("Depth extension not supported.")
