"""Edge-aware inverse-depth smoothness, NHWC (port of ``losses/smoothness.py``)."""

from __future__ import annotations

import torch

from packnet_sfm_tpu_torch.ops.image import gradient_x, gradient_y


def normalize_inv_depth(inv_depth: torch.Tensor) -> torch.Tensor:
    """Divide by the per-image spatial mean."""
    mean = inv_depth.mean(dim=(1, 2), keepdim=True)
    return inv_depth / mean.clamp(min=1e-6)


def calc_smoothness(inv_depth: torch.Tensor, image: torch.Tensor):
    """Edge-weighted inverse-depth gradients for one scale: inv_depth
    [B, H, W, 1], image [B, H, W, 3] -> ([B, H, W-1, 1], [B, H-1, W, 1]).
    The edge weights are computed in float32 on any image, as XLA computes
    the JAX package's fused chain of them on a bfloat16 image."""
    image = image.float()
    inv_norm = normalize_inv_depth(inv_depth)
    wx = torch.exp(-torch.mean(torch.abs(gradient_x(image)), dim=-1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(gradient_y(image)), dim=-1, keepdim=True))
    return gradient_x(inv_norm) * wx, gradient_y(inv_norm) * wy


def smoothness_loss(inv_depths: list, images: list, weight: float) -> torch.Tensor:
    """Multi-scale smoothness loss with 1/2^i scale decay.

    Each scale SUMS mean|sx| + mean|sy| (not halved), as the JAX package
    does since its lockstep harness caught a factor-2 bug there.
    """
    n = len(inv_depths)
    total = 0.0
    for i in range(n):
        sx, sy = calc_smoothness(inv_depths[i], images[i])
        total = total + (sx.abs().mean() + sy.abs().mean()) / (2 ** i)
    return weight * total / n
