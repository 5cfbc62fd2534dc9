"""Image-space ops, NHWC layout (port of ``packnet_sfm_tpu/ops/image.py``)."""

from __future__ import annotations

import torch


def image_grid(h: int, w: int, dtype=torch.float32, normalized: bool = False, *,
               device) -> torch.Tensor:
    """Homogeneous pixel grid [H, W, 3] with entries (u, v, 1), unbatched."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    if normalized:
        ys = ys / (h - 1)
        xs = xs / (w - 1)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=-1)


def flip_lr(image: torch.Tensor) -> torch.Tensor:
    """Horizontally flip [..., H, W, C] images."""
    return image.flip(-2)


def gradient_x(image: torch.Tensor) -> torch.Tensor:
    """Finite-difference gradient along W: [B, H, W-1, C]."""
    return image[:, :, :-1, :] - image[:, :, 1:, :]


def gradient_y(image: torch.Tensor) -> torch.Tensor:
    """Finite-difference gradient along H: [B, H-1, W, C]."""
    return image[:, :-1, :, :] - image[:, 1:, :, :]


def interpolate_image(image: torch.Tensor, shape, mode: str = "bilinear") -> torch.Tensor:
    """Resize [B, H, W, C] to spatial ``shape`` (H', W').

    'bilinear' is align_corners=True, gathered through an explicit grid as
    the JAX package does (``F.interpolate``'s default is half-pixel
    centres, which is another function). 'nearest' takes source index
    floor((i + 0.5) * S / S') like ``jax.image.resize``; that is
    ``F.interpolate``'s 'nearest-exact', and its 'nearest' only for integer
    factors.
    """
    h, w = int(shape[0]), int(shape[1])
    if image.shape[1] == h and image.shape[2] == w:
        return image
    if mode == "nearest":
        return _resize_nearest(image, h, w)
    if mode != "bilinear":
        raise ValueError(f"unknown resize mode {mode!r}")
    return _resize_bilinear_align_corners(image, h, w)


def _nearest_index(size_in: int, size_out: int, device) -> torch.Tensor:
    # float32 on purpose: jax.image.resize computes these offsets in float32.
    i = torch.arange(size_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * size_in / size_out).long().clamp_(0, size_in - 1)


def _resize_nearest(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    _, ih, iw, _ = image.shape
    if ih != h:
        image = image[:, _nearest_index(ih, h, image.device)]
    if iw != w:
        image = image[:, :, _nearest_index(iw, w, image.device)]
    return image


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


def match_scales(image: torch.Tensor, shapes, mode: str = "bilinear") -> list:
    """Resize ``image`` to each (H, W) in ``shapes`` (same tensor when equal)."""
    return [interpolate_image(image, s, mode=mode) for s in shapes]
