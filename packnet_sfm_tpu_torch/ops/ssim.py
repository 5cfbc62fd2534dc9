"""SSIM distance for photometric losses, NHWC (port of ``ops/ssim.py``).

3x3 average pooling over 1-pixel reflection-padded inputs, C1=1e-4, C2=9e-4.
The inputs are padded once and every moment is pooled over the padded
values (the padding copies values, so the square of the padded input is the
padded square). Given a ``band`` (``parallel/spatial.Band``) the inputs are
bands of rows: their rows come from the neighbouring bands, and the
reflection from the whole image's top and bottom.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.parallel import spatial


def _pad_reflect1(x: torch.Tensor, y: torch.Tensor, band: Optional["spatial.Band"]):
    """NHWC ``x`` and ``y`` as NCHW, padded by 1 with the reflection; on a
    band, the rows across its edges come from the neighbouring bands, both
    images' in one exchange."""
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    if band is None:
        return F.pad(x, (1, 1, 1, 1), mode="reflect"), F.pad(y, (1, 1, 1, 1), mode="reflect")
    xy = spatial.reflect_pad_rows(torch.cat([x, y], dim=1), band=band)
    xy = F.pad(xy, (1, 1, 0, 0), mode="reflect")
    return xy[:, :x.shape[1]], xy[:, x.shape[1]:]


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 1e-4,
         c2: float = 9e-4, band: Optional["spatial.Band"] = None) -> torch.Tensor:
    """SSIM similarity map between two [B, H, W, C] images."""
    x, y = _pad_reflect1(x, y, band)

    def pool(t):
        return F.avg_pool2d(t, 3, stride=1)

    mu_x = pool(x)
    mu_y = pool(y)
    mu_xy = mu_x * mu_y
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    sigma_x = pool(x * x) - mu_xx
    sigma_y = pool(y * y) - mu_yy
    sigma_xy = pool(x * y) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return (num / den).permute(0, 2, 3, 1)


def ssim_loss(x: torch.Tensor, y: torch.Tensor, c1: float = 1e-4,
              c2: float = 9e-4, band: Optional["spatial.Band"] = None) -> torch.Tensor:
    """Clipped SSIM distance in [0, 1]."""
    return torch.clamp((1.0 - ssim(x, y, c1, c2, band)) * 0.5, 0.0, 1.0)
