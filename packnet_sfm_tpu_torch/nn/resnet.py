"""ResNet encoder and monodepth2 depth decoder (port of ``nn/resnet.py``).

Modules take and return NCHW tensors; the networks that use them
(``nn/raysurface.py``) keep NHWC at their public boundary. Submodule names
follow the flax module tree so ``utils/convert.from_jax`` maps weights by
name. This slice ports ResNet-18 (BasicBlock) only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def kaiming_fan_out_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax variance_scaling(2.0, 'fan_out', 'normal')."""
    nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu", generator=gen)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default conv init: variance_scaling(1.0, 'fan_in',
    'truncated_normal') — the std is corrected for the truncation at 2."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class BatchNorm(nn.Module):
    """BatchNorm with flax's semantics (momentum 0.9, eps 1e-5).

    Training normalizes with the batch statistics and moves the running
    statistics by 0.1 towards them, with the BIASED batch variance as flax
    does (``torch.nn.BatchNorm2d`` moves them towards the unbiased one).
    """

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.epsilon)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.epsilon)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, features, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(features)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """ResNet-18 feature pyramid: 5 features at strides (2, 4, 8, 16, 32)."""

    num_ch_enc = (64, 64, 128, 256, 512)

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers != 18:
            raise NotImplementedError(
                f"ResNet-{num_layers} is not ported yet (ROADMAP.md); only 18 is")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, width in enumerate((64, 128, 256, 512)):
            stride = 1 if li == 0 else 2
            for bi in range(2):
                need_ds = bi == 0 and (stride != 1 or cin != width)
                self.add_module(f"layer{li + 1}_{bi}", BasicBlock(
                    cin, width, stride if bi == 0 else 1, need_ds))
                cin = width

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x: torch.Tensor) -> list:
        x = (x - 0.45) / 0.225
        f0 = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(f0, 3, stride=2, padding=1)
        feats = [f0]
        for li in range(4):
            for bi in range(2):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            feats.append(x)
        return feats


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by 1 with reflection, as
    ``jnp.pad(mode="reflect")`` does: an axis of one pixel repeats it
    (``F.pad``'s reflection refuses an axis no longer than the pad)."""
    h, w = x.shape[-2:]
    if h > 1 and w > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if h > 1 else "replicate")


class ConvBlockRefl(nn.Module):
    """3x3 reflect-pad conv + ELU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(reflect_pad1(x)))


class Conv3x3Refl(nn.Module):
    """3x3 reflect-pad conv, no activation."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad1(x))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def init_decoder_weights(module: nn.Module, gen: torch.Generator) -> None:
    """flax Conv defaults: lecun-normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, gen)
            nn.init.zeros_(m.bias)


class DepthDecoder(nn.Module):
    """monodepth2 depth decoder over the ResNet-18 pyramid: sigmoid disp
    heads at the 4 finest scales (``heads=False`` builds the trunk only).
    Returns [disp0 (full res), disp1, disp2, disp3]."""

    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, heads: bool = True):
        super().__init__()
        enc, dec = ResNetEncoder.num_ch_enc, self.num_ch_dec
        cin = enc[-1]
        for i in range(4, -1, -1):
            self.add_module(f"upconv_{i}_0", ConvBlockRefl(cin, dec[i]))
            skip = enc[i - 1] if i > 0 else 0
            self.add_module(f"upconv_{i}_1", ConvBlockRefl(dec[i] + skip, dec[i]))
            cin = dec[i]
            if heads and i < 4:
                self.add_module(f"dispconv_{i}", Conv3x3Refl(dec[i], 1))

    def _trunk(self, features: list):
        x = features[-1]
        for i in range(4, -1, -1):
            x = _upsample2(getattr(self, f"upconv_{i}_0")(x))
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = getattr(self, f"upconv_{i}_1")(x)
            yield i, x

    def forward(self, features: list) -> list:
        disps = {i: torch.sigmoid(getattr(self, f"dispconv_{i}")(x))
                 for i, x in self._trunk(features) if i < 4}
        return [disps[0], disps[1], disps[2], disps[3]]
