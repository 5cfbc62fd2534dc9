"""Building-block layers for PackNet-style networks (port of
``packnet_sfm_tpu/nn/layers.py``). Modules take and return NCHW tensors.

Submodules are named after the flax module tree (``Conv_0`` -> ``conv``,
``GroupNorm_0`` -> ``norm``, ``Conv2dBlock_0`` and ``ResidualConv_0`` as they
are), so ``utils/convert.from_jax`` maps weights by name. Kernels are
xavier-uniform and biases zero, drawn by ``init_conv_weights`` from the
caller's generator.
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


def check_dropout(dropout) -> None:
    """Dropout is off (None or 0) on every ported path."""
    if dropout:
        raise NotImplementedError(
            f"dropout {dropout} is not ported yet (ROADMAP.md); use 0.0")


def init_conv_weights(module: nn.Module, gen: torch.Generator) -> None:
    """flax xavier-uniform kernels and zero biases for every 2D and 3D conv
    under ``module`` (weights held as parameters ``weight`` and ``bias``)."""
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(w, nn.Parameter) and w.dim() >= 4:
            nn.init.xavier_uniform_(w, generator=gen)
            nn.init.zeros_(m.bias)


class Conv2dBlock(nn.Module):
    """Conv(k, stride, zero-pad k//2) + GroupNorm(16) + ELU."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel_size, stride=stride,
                              padding=kernel_size // 2)
        self.norm = FastGroupNorm(features, num_groups=16, epsilon=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.norm(self.conv(x)))


class ResidualConv(nn.Module):
    """Residual unit: two Conv2dBlocks + 1x1-conv shortcut, GroupNorm + ELU
    on the sum."""

    def __init__(self, cin: int, features: int, stride: int, dropout=None):
        super().__init__()
        check_dropout(dropout)
        self.Conv2dBlock_0 = Conv2dBlock(cin, features, 3, stride)
        self.Conv2dBlock_1 = Conv2dBlock(features, features, 3, 1)
        self.conv = nn.Conv2d(cin, features, 1, stride=stride)
        self.norm = FastGroupNorm(features, num_groups=16, epsilon=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Conv2dBlock_1(self.Conv2dBlock_0(x))
        return F.elu(self.norm(out + self.conv(x)))


class ResidualBlock(nn.Module):
    """Stack of ResidualConv units; only the first may stride."""

    def __init__(self, cin: int, features: int, num_blocks: int, stride: int = 1,
                 dropout=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"ResidualConv_{i}", ResidualConv(
                cin if i == 0 else features, features, stride if i == 0 else 1, dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualConv_{i}")(x)
        return x


class InvDepthHead(nn.Module):
    """3x3 conv + sigmoid scaled by 1/min_depth: inverse depth in
    (0, 1/min_depth), in float32."""

    def __init__(self, cin: int, features: int = 1, min_depth: float = 0.5):
        super().__init__()
        self.min_depth = min_depth
        self.conv = nn.Conv2d(cin, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv(x).float()) / self.min_depth
