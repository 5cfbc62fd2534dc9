"""Building-block layers for PackNet-style networks (port of
``packnet_sfm_tpu/nn/layers.py``). Modules take and return NCHW tensors.

Submodules are named after the flax module tree (``Conv_0`` -> ``conv``,
``GroupNorm_0`` -> ``norm``, ``Conv2dBlock_0`` and ``ResidualConv_0`` as they
are), so ``utils/convert.from_jax`` maps weights by name. Kernels are
xavier-uniform and biases zero, drawn by ``init_conv_weights`` from the
caller's generator.

``dtype`` is flax's per-module compute dtype: parameters stay float32 and
each layer casts its input and its weights to ``dtype`` where it uses them.
``None`` computes in the dtype that the input and the float32 parameters
promote to, as flax does: a bfloat16 input meets float32 weights in float32.

On a band of rows (``parallel/spatial.use``), ``Conv2d`` takes the rows its
kernel reads across the band's edges from the neighbouring bands and
``FastGroupNorm`` sums its statistics over the space group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from packnet_sfm_tpu_torch.parallel import spatial


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` under a compute dtype, as flax's ``nn.Conv(dtype=...)``:
    the input, kernel and bias are cast to ``compute_dtype`` (None: the
    dtype that the input and the parameters promote to) and the output is in
    it. The parameters themselves stay float32."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.padding[0] and spatial.current() is not None:
            return spatial.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.groups)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class FastGroupNorm(nn.Module):
    """GroupNorm(num_groups) over NCHW with per-channel scale and bias.

    The JAX ``FastGroupNorm`` computes float32 statistics of the upcast
    input, applies the affine in float32 and casts the output once to its
    compute dtype (the input's where ``dtype`` is None); the port does the
    same with ``F.group_norm`` on the float32 input and float32 weights (so
    scale and bias are never rounded to bfloat16). JAX's per-group mean
    shift only guards its one-pass formula against cancellation, in float32
    compute; PyTorch's kernel needs none on a contiguous input, so the CPU
    gets a contiguous one (its channels-last kernel sums E[x^2] - E[x]^2 in
    one pass). Parameters: ``weight`` (flax ``scale``) and ``bias``. On a
    band the statistics are those of the whole image, summed over the space
    group (``parallel/spatial.group_norm``).
    """

    def __init__(self, channels: int, num_groups: int = 16, epsilon: float = 1e-5,
                 dtype=None):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels are not divisible into {num_groups} groups")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        if spatial.current() is not None:
            return spatial.group_norm(x, self.num_groups, self.weight, self.bias,
                                      self.epsilon).to(out_dtype)
        if x.device.type == "cpu":
            x = x.contiguous()
        out = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.epsilon)
        return out.to(out_dtype)


class ShortcutDropout(nn.Module):
    """The dropout on a residual unit's shortcut, as the JAX package builds
    it: the identity in eval and infer. Training with it raises, because
    the JAX package cannot train it either: its ``model_loss`` applies the
    network without a dropout generator, and flax refuses a
    non-deterministic ``Dropout`` without one (``ROADMAP.md`` §3)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError(
                f"dropout {self.rate} in a training forward: the JAX package cannot train "
                "it either (its model_loss passes no dropout generator, and flax raises "
                "InvalidRngError), so the port refuses it; set depth_net.dropout to 0.0 "
                "(eval and infer run it as the identity)")
        return x


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

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 1,
                 dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, stride=stride,
                           padding=kernel_size // 2, compute_dtype=dtype)
        self.norm = FastGroupNorm(features, num_groups=16, epsilon=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.norm(self.conv(x)))


class ResidualConv(nn.Module):
    """Residual unit: two Conv2dBlocks + 1x1-conv shortcut, GroupNorm + ELU
    on the sum."""

    def __init__(self, cin: int, features: int, stride: int, dropout=None, dtype=None):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(cin, features, 3, stride, dtype)
        self.Conv2dBlock_1 = Conv2dBlock(features, features, 3, 1, dtype)
        self.conv = Conv2d(cin, features, 1, stride=stride, compute_dtype=dtype)
        self.norm = FastGroupNorm(features, num_groups=16, epsilon=1e-5, dtype=dtype)
        self.dropout = ShortcutDropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Conv2dBlock_1(self.Conv2dBlock_0(x))
        shortcut = self.conv(x)
        if self.dropout is not None:
            shortcut = self.dropout(shortcut)
        return F.elu(self.norm(out + shortcut))


class ResidualBlock(nn.Module):
    """Stack of ResidualConv units; only the first may stride."""

    def __init__(self, cin: int, features: int, num_blocks: int, stride: int = 1,
                 dropout=None, dtype=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"ResidualConv_{i}", ResidualConv(
                cin if i == 0 else features, features, stride if i == 0 else 1, dropout,
                dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualConv_{i}")(x)
        return x


class InvDepthHead(nn.Module):
    """3x3 conv (in the compute dtype) + sigmoid scaled by 1/min_depth:
    inverse depth in (0, 1/min_depth), in float32 whatever the dtype."""

    def __init__(self, cin: int, features: int = 1, min_depth: float = 0.5, dtype=None):
        super().__init__()
        self.min_depth = min_depth
        self.conv = Conv2d(cin, features, 3, padding=1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv(x).float()) / self.min_depth
