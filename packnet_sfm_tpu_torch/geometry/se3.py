"""SE(3) exp/log maps (port of ``packnet_sfm_tpu/geometry/se3.py``).

Closed-form Rodrigues formulas with Taylor series near theta = 0, as in
the JAX package. The pose graph and the direct alignment take their
Jacobians at a twist of 0, exactly the theta = 0 branch, so every branch
evaluates its square root and divisions on a safe value
(``torch.where(small, 1, theta^2)``): both sides of a ``torch.where`` are
computed, and ``sqrt(0)`` would give NaN tangents in forward mode and NaN
gradients in reverse mode.
"""

from __future__ import annotations

import torch

_SMALL = 1e-10


def _hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _safe_theta(w: torch.Tensor):
    """(small, theta_safe, theta_sq), each [..., 1, 1], with NaN-free
    derivatives at theta = 0."""
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta_sq < _SMALL
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    return small, theta, theta_sq


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] rotation (Rodrigues)."""
    small, theta, theta_sq = _safe_theta(w)
    W = _hat(w)
    W2 = W @ W
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta * theta))
    return _eye3(w, W.shape) + A * W + B * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)[..., None]
    small = theta < 1e-5
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    w_raw = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0,
                        theta_safe / (2.0 * torch.sin(theta_safe)))
    return w_raw * scale


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist [v | w] -> [..., 4, 4] transform."""
    v, w = xi[..., :3], xi[..., 3:]
    small, theta, theta_sq = _safe_theta(w)
    W = _hat(w)
    W2 = W @ W
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta * theta))
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta * theta * theta))
    R = so3_exp(w)
    V = _eye3(xi, W.shape) + B * W + C * W2
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.eye(4, dtype=xi.dtype, device=xi.device)[3]    # no copy from the host
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], -2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] transform -> [..., 6] twist [v | w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    small, theta, theta_sq = _safe_theta(w)
    W = _hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2 - (1+cos)/(2 theta sin)) W^2
    coef = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / (theta * theta)) - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta)))
    Vinv = _eye3(T, W.shape) - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)
