"""Image-space ops, NHWC layout (port of ``packnet_sfm_tpu/ops/image.py``).

``interpolate_image`` also resizes a band of rows of the (data x space)
grid (``parallel/spatial.py``): the band's rows of the whole image's
resize, reading the source rows it needs across the band's edges from the
neighbouring bands.
"""

from __future__ import annotations

from typing import Optional

import torch


def image_grid(h: int, w: int, dtype=torch.float32, normalized: bool = False, *,
               device, row0: int = 0) -> torch.Tensor:
    """Homogeneous pixel grid [H, W, 3] with entries (u, v, 1), unbatched;
    ``row0`` is the first row's v (a band of rows of a larger image;
    not with ``normalized``)."""
    if row0 and normalized:
        raise ValueError("a normalized grid of a band of rows")
    ys = torch.arange(row0, row0 + h, dtype=dtype, device=device)
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


def interpolate_image(image: torch.Tensor, shape, mode: str = "bilinear",
                      band: Optional["spatial.Band"] = None) -> torch.Tensor:
    """Resize [B, H, W, C] to spatial ``shape`` (H', W').

    'bilinear' is align_corners=True, gathered through an explicit grid as
    the JAX package does (``F.interpolate``'s default is half-pixel
    centres, which is another function). 'nearest' takes source index
    floor((i + 0.5) * S / S') like ``jax.image.resize``; that is
    ``F.interpolate``'s 'nearest-exact', and its 'nearest' only for integer
    factors.

    On a ``band`` (``parallel/spatial.Band``) ``image`` is the band's rows
    of an image of H = count x its rows, ``shape`` the whole output's, and
    the result the band's rows of the whole resize: the source rows are the
    whole image's (bilinear reads row i (H - 1) / (H' - 1) and the next,
    nearest the index above), taken across the band's edges where they lie
    there (``spatial.take_rows``).
    """
    h, w = int(shape[0]), int(shape[1])
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"unknown resize mode {mode!r}")
    if band is not None:
        return _resize_band(image, h, w, mode, band)
    if image.shape[1] == h and image.shape[2] == w:
        return image
    if mode == "nearest":
        return _resize_nearest(image, h, w)
    return _resize_bilinear_align_corners(image, h, w)


def _resize_band(image: torch.Tensor, h: int, w: int, mode: str, band) -> torch.Tensor:
    """``interpolate_image`` on a band: the whole resize's source rows (and
    weights) for every output row, then this band's output rows from the
    source rows they read."""
    from packnet_sfm_tpu_torch.parallel import spatial

    ih = band.rows(image.shape[1])
    if h % band.count:
        raise ValueError(f"a resize to {h} rows does not split into {band.count} bands")
    if ih != h:
        ob = h // band.count
        if mode == "nearest":
            index, nxt, weight = _nearest_index(ih, h, image.device), None, None
        else:
            index, nxt, weight = _bilinear_rows(ih, h, image.dtype, image.device)
        # the rows each band reads, from a host copy of the indices (no
        # wait for the device): its linspace may round an index to the
        # next row, so one row more each way
        host = (_nearest_index(ih, h, "cpu") if mode == "nearest"
                else _bilinear_rows(ih, h, image.dtype, "cpu")[0])

        def bounds(i):
            return (max(int(host[i * ob]) - 1, 0), min(int(host[(i + 1) * ob - 1]) + 3, ih))

        rows = spatial.take_rows(image, bounds, dim=1, band=band)
        mine = slice(band.index * ob, (band.index + 1) * ob)
        start = bounds(band.index)[0]
        image = rows[:, index[mine] - start]
        if mode == "bilinear":
            wy = weight[mine][None, :, None, None]
            image = image * (1 - wy) + rows[:, nxt[mine] - start] * wy
    if image.shape[2] == w:
        return image
    if mode == "nearest":
        return image[:, :, _nearest_index(image.shape[2], w, image.device)]
    return _resize_bilinear_align_corners(image, image.shape[1], w)


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


def _source_positions(size_in: int, size_out: int, dtype, device) -> torch.Tensor:
    """linspace(0, size_in - 1, size_out) in ``dtype``, as the JAX package's
    ``jnp.linspace(..., dtype=image.dtype)`` gives it. In float32 that is
    ``torch.linspace``; in a narrower dtype jnp computes step = iota / div
    and stop * step in that dtype, rounding the iota, div (383 is 384 in
    bfloat16) and both results, which ``torch.linspace`` does not."""
    if dtype == torch.float32 or size_out < 2:
        return torch.linspace(0.0, size_in - 1.0, size_out, dtype=dtype, device=device)
    div = size_out - 1
    iota = torch.arange(div, dtype=torch.float32, device=device).to(dtype)
    # the scalars filled on the device: a host-built tensor's copy would wait
    # for the stream
    stop = torch.full((), size_in - 1.0, dtype=dtype, device=device)
    return torch.cat([stop * (iota / torch.full((), float(div), dtype=dtype, device=device)),
                      stop[None]])


def _bilinear_rows(size_in: int, size_out: int, dtype, device):
    """For each output row of an align_corners resize: (the source row, the
    next, the next's weight)."""
    ys = _source_positions(size_in, size_out, dtype, device)
    y0 = torch.floor(ys).clamp(0, size_in - 1)
    y1 = (y0 + 1).clamp(0, size_in - 1)

    def index(v):
        # a narrow dtype may round the clamp's bound past the edge (639 is
        # 640 in bfloat16); JAX's gather clamps the index, so this does too
        return v.long().clamp_(0, size_in - 1)

    return index(y0), index(y1), ys - y0


def _resize_bilinear_align_corners(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    _, ih, iw, _ = image.shape
    y0, y1, wy = _bilinear_rows(ih, h, image.dtype, image.device)
    x0, x1, wx = _bilinear_rows(iw, w, image.dtype, image.device)
    wy = wy[None, :, None, None]
    wx = wx[None, None, :, None]
    # Separable gather: rows then columns.
    top = image[:, y0]
    bot = image[:, y1]
    rows = top * (1 - wy) + bot * wy
    left = rows[:, :, x0]
    right = rows[:, :, x1]
    return left * (1 - wx) + right * wx


def match_scales(image: torch.Tensor, shapes, mode: str = "bilinear") -> list:
    """Resize ``image`` to each (H, W) in ``shapes`` (same tensor when equal)."""
    return [interpolate_image(image, s, mode=mode) for s in shapes]
