"""SSIM distance for photometric losses, NHWC (port of ``ops/ssim.py``).

3x3 average pooling over 1-pixel reflection-padded inputs, C1=1e-4, C2=9e-4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg_pool3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-1 mean after a 1px reflection pad, on NCHW."""
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, stride=1)


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 1e-4,
         c2: float = 9e-4) -> torch.Tensor:
    """SSIM similarity map between two [B, H, W, C] images."""
    x = x.permute(0, 3, 1, 2)
    y = y.permute(0, 3, 1, 2)
    mu_x = _avg_pool3_reflect(x)
    mu_y = _avg_pool3_reflect(y)
    mu_xy = mu_x * mu_y
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    sigma_x = _avg_pool3_reflect(x * x) - mu_xx
    sigma_y = _avg_pool3_reflect(y * y) - mu_yy
    sigma_xy = _avg_pool3_reflect(x * y) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return (num / den).permute(0, 2, 3, 1)


def ssim_loss(x: torch.Tensor, y: torch.Tensor, c1: float = 1e-4,
              c2: float = 9e-4) -> torch.Tensor:
    """Clipped SSIM distance in [0, 1]."""
    return torch.clamp((1.0 - ssim(x, y, c1, c2)) * 0.5, 0.0, 1.0)
