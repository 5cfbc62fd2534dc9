"""Differentiable bilinear warp sampling, NHWC (port of ``ops/warp.py``).

The JAX package computes this with XLA ops, outside any Pallas kernel, so
the port calls ``F.grid_sample`` (bilinear, align_corners=True). Its
hand-written Hopper kernel, fused with the reconstruct -> project of the
pinhole camera, is K1 of a later slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``image`` [B, H, W, C] at ``coords`` [B, H', W', 2].

    ``coords[..., 0]`` is x and ``coords[..., 1]`` is y, normalized to
    [-1, 1] with align_corners=True (-1 -> pixel 0, +1 -> pixel S-1).
    padding_mode 'zeros' or 'border', as in torch.
    """
    out = F.grid_sample(image.permute(0, 3, 1, 2), coords, mode="bilinear",
                        padding_mode=padding_mode, align_corners=True)
    return out.permute(0, 2, 3, 1)
