"""Inverse-depth visualization: the port's own copy of
``packnet_sfm_tpu/utils/viz.py`` (same image for the same map). matplotlib
is imported where it is used."""

from __future__ import annotations

import numpy as np


def viz_inv_depth(inv_depth: np.ndarray, normalizer=None, percentile=95,
                  colormap: str = "plasma", filter_zeros: bool = False) -> np.ndarray:
    """[H, W] inverse depth -> [H, W, 3] colormapped float image in [0, 1]."""
    import matplotlib
    cm = matplotlib.colormaps[colormap]
    inv_depth = np.asarray(inv_depth, np.float32)
    if normalizer is None:
        vals = inv_depth[inv_depth > 0] if filter_zeros else inv_depth
        normalizer = np.percentile(vals, percentile) if vals.size else 1.0
    norm = inv_depth / (normalizer + 1e-6)
    return cm(np.clip(norm, 0.0, 1.0))[:, :, :3].astype(np.float32)
