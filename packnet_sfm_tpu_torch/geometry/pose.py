"""Differentiable SE(3) utilities (port of ``packnet_sfm_tpu/geometry/pose.py``).

A pose is a ``[..., 4, 4]`` tensor. Conventions match the JAX package:
``euler_to_rotation`` builds R = Rx @ Ry @ Rz and ``pose_vec_to_mat`` takes
[tx, ty, tz, rx, ry, rz].
"""

from __future__ import annotations

import torch


def euler_to_rotation(angles: torch.Tensor) -> torch.Tensor:
    """[..., 3] euler angles (x, y, z) -> [..., 3, 3] rotation, R = Rx·Ry·Rz."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    rows = [
        [cy * cz, -cy * sz, sy],
        [cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy],
        [sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def pose_vec_to_mat(vec: torch.Tensor, mode: str = "euler") -> torch.Tensor:
    """[..., 6] pose vector [t | r] -> [..., 4, 4] SE(3) matrix."""
    if mode != "euler":
        raise ValueError(f"Unsupported rotation mode: {mode}")
    rot = euler_to_rotation(vec[..., 3:6])
    top = torch.cat([rot, vec[..., :3, None]], dim=-1)          # [..., 3, 4]
    return torch.cat([top, _bottom_row(top)], dim=-2)


def invert_pose(T: torch.Tensor) -> torch.Tensor:
    """Invert [..., 4, 4] SE(3): (R, t) -> (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T[..., :3, 3:]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def compose_poses(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Compose two [..., 4, 4] transforms: returns Ta @ Tb."""
    return Ta @ Tb


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [B, 4, 4] SE(3) to [B, H, W, 3] points (NHWC layout)."""
    out = torch.einsum("bij,bhwj->bhwi", T[:, :3, :3], points)
    return out + T[:, None, None, :3, 3]


def identity_pose(batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[B, 4, 4] identity transforms (an expanded view of one identity)."""
    return torch.eye(4, dtype=dtype, device=device).expand(batch, 4, 4)
