"""Differentiable pinhole camera, functional, NHWC (port of
``geometry/camera.py``).

Conventions, as in the JAX package:
- ``Tcw`` is the world->camera transform; ``reconstruct`` lifts to world via
  ``Twc = inv(Tcw)``.
- ``project`` returns pixel coords normalized to [-1, 1] with
  align_corners=True semantics and z clamped at 1e-5.
- ``scale_intrinsics`` uses the +0.5 pixel-centre convention.
Intrinsics are applied per scalar (fx, fy, cx, cy), not by 3x3 products.

A depth map may be a band of rows of the image (``parallel/spatial.py``):
``reconstruct`` then takes the band's first row (``row0``), so that its
pixels' v are the image's, and ``project`` the image's height, so that v
normalizes by the whole image's H - 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from packnet_sfm_tpu_torch.geometry.pose import invert_pose, transform_points
from packnet_sfm_tpu_torch.ops.image import image_grid
from packnet_sfm_tpu_torch.ops.warp import grid_sample


class Camera(NamedTuple):
    """Pinhole camera: intrinsics ``K`` [B, 3, 3] + optional world->cam
    ``Tcw`` [B, 4, 4]."""

    K: torch.Tensor
    Tcw: Optional[torch.Tensor] = None


def _intrinsics_matrix(like: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    out = torch.zeros_like(like)
    out[..., 0, 0] = fx
    out[..., 1, 1] = fy
    out[..., 0, 2] = cx
    out[..., 1, 2] = cy
    out[..., 2, 2] = 1.0
    return out


def scale_intrinsics(K: torch.Tensor, x_scale: float, y_scale: Optional[float] = None) -> torch.Tensor:
    """Rescale intrinsics for a resized image."""
    if y_scale is None:
        y_scale = x_scale
    return _intrinsics_matrix(
        K, K[..., 0, 0] * x_scale, K[..., 1, 1] * y_scale,
        (K[..., 0, 2] + 0.5) * x_scale - 0.5, (K[..., 1, 2] + 0.5) * y_scale - 0.5)


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a pinhole K."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return _intrinsics_matrix(K, 1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy)


def _fxfycxcy(K: torch.Tensor):
    return (K[:, 0, 0][:, None, None], K[:, 1, 1][:, None, None],
            K[:, 0, 2][:, None, None], K[:, 1, 2][:, None, None])


def reconstruct(cam: Camera, depth: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Lift a depth map [B, H, W, 1] (rows ``row0`` on of the image) to
    world-frame points [B, H, W, 3]."""
    _, h, w, _ = depth.shape
    grid = image_grid(h, w, dtype=depth.dtype, device=depth.device, row0=row0)  # (u, v, 1)
    fx, fy, cx, cy = _fxfycxcy(cam.K)
    d = depth[..., 0]
    x = (grid[None, ..., 0] - cx) / fx * d
    y = (grid[None, ..., 1] - cy) / fy * d
    pts_c = torch.stack([x, y, d], dim=-1)
    if cam.Tcw is None:
        return pts_c
    return transform_points(invert_pose(cam.Tcw), pts_c)


def project(cam: Camera, points: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
    """Project world points [B, H, W, 3] to normalized pixel coords
    [B, H, W, 2] in [-1, 1] (align_corners=True) of an image of ``height``
    rows (None: H); z clamped at 1e-5."""
    _, h, w, _ = points.shape
    h = height or h
    if cam.Tcw is not None:
        points = transform_points(cam.Tcw, points)
    fx, fy, cx, cy = _fxfycxcy(cam.K)
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    Z = Z.clamp(min=1e-5)
    u = fx * X / Z + cx
    v = fy * Y / Z + cy
    return torch.stack([2.0 * u / (w - 1) - 1.0, 2.0 * v / (h - 1) - 1.0], dim=-1)


def view_synthesis(ref_image: torch.Tensor, depth: torch.Tensor, ref_cam: Camera,
                   cam: Camera, padding_mode: str = "zeros", row0: int = 0,
                   height: Optional[int] = None) -> torch.Tensor:
    """Warp ``ref_image`` into the frame of ``cam`` given its ``depth``:
    reconstruct -> project -> bilinear grid sample (the warp kernels on
    CUDA tensors). ``depth`` may be the band of rows ``row0`` on of an
    image of ``height`` rows: the warp then samples the whole
    ``ref_image`` at the band's coordinates."""
    world_points = reconstruct(cam, depth, row0)
    ref_coords = project(ref_cam, world_points, height)
    return grid_sample(ref_image, ref_coords, padding_mode=padding_mode)
