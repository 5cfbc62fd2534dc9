"""Generic (neural ray surface) camera (port of ``geometry/camera_generic.py``).

Per-pixel ray-surface camera: ``generic_reconstruct`` is P = r(x, y) * d(x, y);
``generic_project`` finds each 3D point's correspondence by a soft-argmax
over dot-products with the reference ray surface in a local (2p+1)^2 window
(kernels K6f/K6b, ``ops/softargmax.py``), at half resolution by default.

The temperature is a Python float from ``projection_temperature(progress)``,
computed on the host. (The JAX package's model_loss computes it as a traced
scalar, which its Pallas projector cannot take under jit; the port does not
copy that.)

On a band of rows of the (data x space) grid (``parallel/spatial.py``) the
cameras' rays and the points are the band's rows: ``generic_project``
resizes them as the whole image's rows (``ops/image.interpolate_image`` on
the band), takes the slab of the half-resolution ray surface that the
band's windows read from the neighbouring bands (``spatial.take_rows``),
runs the soft-argmax's band form and normalizes by the whole image's height,
so that ``view_synthesis_generic`` samples the whole context at the band's
coordinates.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from packnet_sfm_tpu_torch.engine import spans
from packnet_sfm_tpu_torch.geometry.pose import invert_pose, transform_points
from packnet_sfm_tpu_torch.ops.image import interpolate_image
from packnet_sfm_tpu_torch.ops.softargmax import (
    ray_slab,
    softargmax_coords,
    softargmax_coords_plain,
)
from packnet_sfm_tpu_torch.ops.warp import grid_sample
from packnet_sfm_tpu_torch.parallel import spatial


class GenericCamera(NamedTuple):
    """Ray-surface camera: rays [B, H, W, 3] + optional world->cam Tcw [B, 4, 4]."""

    rays: torch.Tensor
    Tcw: Optional[torch.Tensor] = None


def generic_reconstruct(cam: GenericCamera, depth: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] depth -> world points: P = rays * depth."""
    pts_c = cam.rays * depth
    if cam.Tcw is None:
        return pts_c
    return transform_points(invert_pose(cam.Tcw), pts_c)


def projection_temperature(progress: float, start: float = 1e-4,
                           constant: float = 0.1, floor: float = 1e-8) -> float:
    """Annealed softmax temperature, a host float."""
    return max(floor, start / math.exp(constant * float(progress)))


def generic_project(
    cam: GenericCamera,
    X: torch.Tensor,
    temperature: float,
    patch: int = 20,
    downsample: bool = True,
    projector: str = "auto",
    band: Optional[spatial.Band] = None,
) -> torch.Tensor:
    """Project world points [B, H, W, 3] to normalized coords [B, H, W, 2].

    projector: 'auto' is ``softargmax_coords`` (the kernels on CUDA tensors);
    'plain' forces ``softargmax_coords_plain``, to hold the kernels to it.
    On a ``band`` the points and rays are the band's H rows of an image of
    band.rows(H), and so are the coordinates (see the module docstring).
    Runs under the span ``generic_project`` (``engine/spans.py``).
    """
    with spans.span("generic_project"):
        b, H, W, _ = X.shape
        H_all = H if band is None else band.rows(H)
        rays = cam.rays
        if cam.Tcw is not None:
            X = transform_points(cam.Tcw, X)
        if downsample:
            h, w = H // 2, W // 2
            rays = interpolate_image(rays, (H_all // 2, w), band=band)
            X = interpolate_image(X, (H_all // 2, w), band=band)
        else:
            h, w = H, W
        h_all = H_all // H * h
        direction = X / torch.linalg.norm(X, dim=-1, keepdim=True).clamp(min=1e-8)

        if projector == "auto":
            project = softargmax_coords
        elif projector == "plain":
            project = softargmax_coords_plain
        else:
            raise ValueError(f"unknown projector {projector!r}")
        rows = {}
        if band is not None:
            def slab(i):
                return ray_slab(i * h, h, h_all, patch)

            rows = dict(row0=band.start(h), height=h_all, ray_row0=slab(band.index)[0])
            rays = spatial.take_rows(rays, slab, dim=1, band=band)
        ex, ey = project(direction.permute(0, 3, 1, 2).contiguous(),
                         rays.permute(0, 3, 1, 2).contiguous(), temperature, patch, **rows)
        # Normalize with the align_corners convention (x by w-1, y by h-1).
        out = torch.stack([2.0 * ex / (w - 1) - 1.0, 2.0 * ey / (h_all - 1) - 1.0], dim=-1)
        if downsample:
            out = interpolate_image(out, (H_all, W), band=band)
        return out


def view_synthesis_generic(
    ref_image: torch.Tensor,
    depth: torch.Tensor,
    ref_cam: GenericCamera,
    cam: GenericCamera,
    temperature: float,
    padding_mode: str = "zeros",
    patch: int = 20,
    band: Optional[spatial.Band] = None,
) -> torch.Tensor:
    """Generic-camera view synthesis: warp ``ref_image`` into ``cam``. On a
    ``band`` the depth and the cameras' rays are the band's rows and
    ``ref_image`` whole: the result is the band's rows."""
    world_points = generic_reconstruct(cam, depth)
    ref_coords = generic_project(ref_cam, world_points, temperature, patch=patch, band=band)
    return grid_sample(ref_image, ref_coords, padding_mode=padding_mode)


def canonical_pinhole_rays(h: int, w: int, fov_deg: float = 90.0, *,
                           device) -> torch.Tensor:
    """Canonical unit ray template [H, W, 3] from a centred pinhole, built in
    float64 with numpy and cast to float32."""
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    ys, xs = np.mgrid[:h, :w].astype(np.float64)
    x = (xs - (w - 1) / 2) / f
    y = (ys - (h - 1) / 2) / f
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return torch.as_tensor(rays.astype(np.float32), device=device)
