"""Building-block layers (port of ``packnet_sfm_tpu/nn/layers.py``), NCHW.

This slice ports the GroupNorm that PoseNet uses; the PackNet blocks come
with the PackNet01 slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FastGroupNorm(nn.Module):
    """GroupNorm(num_groups) over NCHW with per-channel scale and bias.

    The JAX ``FastGroupNorm`` computes the same statistics as a plain group
    norm (its f32 mean shift only guards against cancellation), so the port
    calls ``F.group_norm``. Parameters: ``weight`` (flax ``scale``) and
    ``bias``.
    """

    def __init__(self, channels: int, num_groups: int = 16, epsilon: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels are not divisible into {num_groups} groups")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.epsilon)
