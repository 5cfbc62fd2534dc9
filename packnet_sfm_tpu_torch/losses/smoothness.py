"""Edge-aware inverse-depth smoothness, NHWC (port of ``losses/smoothness.py``).

Given a ``band`` (``parallel/spatial.Band``) the inverse depths are this
rank's bands of rows and the images whole: the per-image mean is summed over
the space group, the vertical gradient takes the next band's first row, and
the loss is this band's share (the shares sum to the loss over the group).
"""

from __future__ import annotations

from typing import Optional

import torch

from packnet_sfm_tpu_torch.ops.image import gradient_x, gradient_y
from packnet_sfm_tpu_torch.parallel import spatial
from packnet_sfm_tpu_torch.parallel.mesh import all_reduce_sum


def normalize_inv_depth(inv_depth: torch.Tensor,
                        band: Optional[spatial.Band] = None) -> torch.Tensor:
    """Divide by the per-image spatial mean (of the whole image, on a band)."""
    if band is None:
        mean = inv_depth.mean(dim=(1, 2), keepdim=True)
    else:
        h, w = inv_depth.shape[1:3]
        mean = all_reduce_sum(inv_depth.sum(dim=(1, 2), keepdim=True),
                              band.group) / (band.rows(h) * w)
    return inv_depth / mean.clamp(min=1e-6)


def calc_smoothness(inv_depth: torch.Tensor, image: torch.Tensor,
                    band: Optional[spatial.Band] = None):
    """Edge-weighted inverse-depth gradients for one scale: inv_depth
    [B, H, W, 1], image [B, H, W, 3] -> ([B, H, W-1, 1], [B, H-1, W, 1]).
    The edge weights are computed in float32 on any image, as XLA computes
    the JAX package's fused chain of them on a bfloat16 image. On a band
    (inv_depth h rows, image whole): ([B, h, W-1, 1], [B, h, W, 1]), h - 1
    rows on the last band."""
    image = image.float()
    inv_norm = normalize_inv_depth(inv_depth, band)
    if band is not None:
        h = inv_depth.shape[1]
        image = image[:, band.start(h):band.start(h) + h + 1]    # and the next band's row
        below = spatial.halo(inv_norm, 0, 1, dim=1, band=band)
        gy = gradient_y(below[:, :image.shape[1]])
        image_x = image[:, :h]
    else:
        gy, image_x = gradient_y(inv_norm), image
    wx = torch.exp(-torch.mean(torch.abs(gradient_x(image_x)), dim=-1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(gradient_y(image)), dim=-1, keepdim=True))
    return gradient_x(inv_norm) * wx, gy * wy


def smoothness_loss(inv_depths: list, images: list, weight: float,
                    band: Optional[spatial.Band] = None) -> torch.Tensor:
    """Multi-scale smoothness loss with 1/2^i scale decay.

    Each scale SUMS mean|sx| + mean|sy| (not halved), as the JAX package
    does since its lockstep harness caught a factor-2 bug there. On a band
    the means are over the whole image's pixel counts.
    """
    n = len(inv_depths)
    total = 0.0
    for i in range(n):
        sx, sy = calc_smoothness(inv_depths[i], images[i], band)
        if band is None:
            term = sx.abs().mean() + sy.abs().mean()
        else:
            b, h, w = inv_depths[i].shape[:3]
            rows = band.rows(h)
            term = sx.abs().sum() / (b * rows * (w - 1)) + sy.abs().sum() / (b * (rows - 1) * w)
        total = total + term / (2 ** i)
    return weight * total / n
