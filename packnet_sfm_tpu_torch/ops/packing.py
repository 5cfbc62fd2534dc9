"""Space-to-depth packing and depth-to-space unpacking, NHWC (port of
``ops/packing.py``).

Channel order is (c, ry, rx): packed channel ``c*r*r + ry*r + rx``, so a
following convolution sees the same channel semantics as in the JAX
package. On an NCHW view that is exactly ``F.pixel_unshuffle`` /
``F.pixel_shuffle``; the permutes around them are views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/r, W/r, C*r*r], channel order (c, ry, rx)."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B, H, W, C*r*r] (channel order (c, ry, rx)) -> [B, H*r, W*r, C]."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
