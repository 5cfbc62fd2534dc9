"""Image-space ops, NHWC layout (port of ``packnet_sfm_tpu/ops/image.py``)."""

from __future__ import annotations

import torch


def gradient_x(image: torch.Tensor) -> torch.Tensor:
    """Finite-difference gradient along W: [B, H, W-1, C]."""
    return image[:, :, :-1, :] - image[:, :, 1:, :]


def gradient_y(image: torch.Tensor) -> torch.Tensor:
    """Finite-difference gradient along H: [B, H-1, W, C]."""
    return image[:, :-1, :, :] - image[:, 1:, :, :]


def interpolate_image(image: torch.Tensor, shape) -> torch.Tensor:
    """Resize [B, H, W, C] to spatial ``shape`` (H', W'); nearest mode is
    not ported yet.

    Bilinear with align_corners=True, gathered through an explicit grid as
    the JAX package does (``F.interpolate``'s default is half-pixel
    centres, which is another function).
    """
    h, w = int(shape[0]), int(shape[1])
    if image.shape[1] == h and image.shape[2] == w:
        return image
    return _resize_bilinear_align_corners(image, h, w)


def _resize_bilinear_align_corners(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    _, ih, iw, _ = image.shape
    ys = torch.linspace(0.0, ih - 1.0, h, dtype=image.dtype, device=image.device)
    xs = torch.linspace(0.0, iw - 1.0, w, dtype=image.dtype, device=image.device)
    y0 = torch.floor(ys).clamp(0, ih - 1)
    x0 = torch.floor(xs).clamp(0, iw - 1)
    y1 = (y0 + 1).clamp(0, ih - 1)
    x1 = (x0 + 1).clamp(0, iw - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    # Separable gather: rows then columns.
    top = image[:, y0.long()]
    bot = image[:, y1.long()]
    rows = top * (1 - wy) + bot * wy
    left = rows[:, :, x0.long()]
    right = rows[:, :, x1.long()]
    return left * (1 - wx) + right * wx


def match_scales(image: torch.Tensor, shapes) -> list:
    """Resize ``image`` to each (H, W) in ``shapes`` (same tensor when equal)."""
    return [interpolate_image(image, s) for s in shapes]
