"""ResNet encoder and monodepth2 depth decoder (port of ``nn/resnet.py``).

Modules take and return NCHW tensors; the networks that use them
(``nn/{depth_resnet,raysurface,pose_resnet}.py``) keep NHWC at their public
boundary. Submodule names follow the flax module tree so
``utils/convert.from_jax`` maps weights by name. ResNet-18/34 are built of
``BasicBlock``, 50/101/152 of ``Bottleneck`` (expansion 4).

On a band of rows (``parallel/spatial.py``; DepthResNet's encoder and
decoder) the padded convolutions (``nn/layers.Conv2d``), the stem's max pool
and the decoder's reflection pads take their rows across the band's edges
from the neighbouring bands; BatchNorm's statistics are the global batch's
already, every band being as large as the others.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from packnet_sfm_tpu_torch.nn.layers import Conv2d
from packnet_sfm_tpu_torch.parallel import spatial
from packnet_sfm_tpu_torch.parallel.mesh import batch_group, global_mean_var


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
    With more than one rank the batch is the global one, as in the JAX
    package's step over a globally sharded batch: the mean and variance are
    taken over every rank's rows (``parallel/mesh.global_mean_var``, whose
    gradients cross the ranks), and every rank moves its running
    statistics by the same values. (``torch.nn.SyncBatchNorm`` keeps the
    unbiased running variance and takes no CPU tensor.)
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
        group = batch_group()
        if group is not None:
            return self._global_batch_norm(x, group)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._move_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.epsilon)

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)

    def _global_batch_norm(self, x: torch.Tensor, group) -> torch.Tensor:
        mean, var = global_mean_var(x, (0, 2, 3), group)
        with torch.no_grad():
            self._move_running(mean.flatten(), var.flatten())
        scale = torch.rsqrt(var + self.epsilon) * self.weight.view(1, -1, 1, 1)
        return (x - mean) * scale + self.bias.view(1, -1, 1, 1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
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


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to 4x ``features``, with the 1x1
    projection shortcut where the shape changes."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = features * self.expansion
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, out, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(out)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


# depth -> (block, blocks per stage)
RESNET_CONFIGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def parse_resnet_version(version: str) -> int:
    """A DepthResNet/RaySurfaceResNet version ('18', '50pt', ...) -> its
    layer count, as the JAX package parses it (``rstrip('pt')``, '18' where
    nothing is left)."""
    return int(version.rstrip("pt") or "18")


class ResNetEncoder(nn.Module):
    """ResNet feature pyramid: 5 features at strides (2, 4, 8, 16, 32), of
    ``num_ch_enc`` channels. ``num_input_images`` > 1 widens conv1 to
    3 * n channels for stacked frames (PoseResNet)."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        if num_layers not in RESNET_CONFIGS:
            raise ValueError(f"no ResNet-{num_layers}; one of {sorted(RESNET_CONFIGS)}")
        block, self.layers = RESNET_CONFIGS[num_layers]
        exp = block.expansion
        self.num_ch_enc = (64, 64 * exp, 128 * exp, 256 * exp, 512 * exp)
        self.conv1 = Conv2d(3 * num_input_images, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, width in enumerate((64, 128, 256, 512)):
            stride = 1 if li == 0 else 2
            for bi in range(self.layers[li]):
                need_ds = bi == 0 and (stride != 1 or cin != width * exp)
                self.add_module(f"layer{li + 1}_{bi}", block(
                    cin, width, stride if bi == 0 else 1, need_ds))
                cin = width * exp

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x: torch.Tensor) -> list:
        # The ResNet family takes no compute dtype: a bfloat16 image meets
        # float32 weights in float32, as flax promotes it (JAX normalizes it
        # in bfloat16 first; the port upcasts it first).
        x = (x.float() - 0.45) / 0.225
        f0 = F.relu(self.bn1(self.conv1(x)))
        if spatial.current() is None:
            x = F.max_pool2d(f0, 3, stride=2, padding=1)
        else:
            x = spatial.max_pool3s2(f0)
        feats = [f0]
        for li, n in enumerate(self.layers):
            for bi in range(n):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            feats.append(x)
        return feats


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by 1 with reflection, as
    ``jnp.pad(mode="reflect")`` does: an axis of one pixel repeats it
    (``F.pad``'s reflection refuses an axis no longer than the pad). On a
    band, the rows come from the neighbouring bands, and the reflection
    from the whole image's top and bottom."""
    h, w = x.shape[-2:]
    if spatial.current() is not None:
        x = spatial.reflect_pad_rows(x)
        return F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
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
    """monodepth2 depth decoder over an encoder pyramid of ``num_ch_enc``
    channels: sigmoid disp heads at the 4 finest scales (``heads=False``
    builds the trunk only). Returns [disp0 (full res), disp1, disp2,
    disp3]."""

    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, num_ch_enc, heads: bool = True):
        super().__init__()
        enc, dec = num_ch_enc, self.num_ch_dec
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


class PoseDecoder(nn.Module):
    """monodepth2 pose decoder on the last encoder feature: squeeze (1x1),
    pose_0-1 (3x3) with ReLU, pose_2 (1x1) to 6 values a frame, the spatial
    mean, scaled by 0.01. Returns (axisangle, translation), each [B,
    ``num_frames``, 1, 3]."""

    def __init__(self, cin: int, num_frames: int = 2):
        super().__init__()
        self.num_frames = num_frames
        self.squeeze = nn.Conv2d(cin, 256, 1)
        self.pose_0 = nn.Conv2d(256, 256, 3, padding=1)
        self.pose_1 = nn.Conv2d(256, 256, 3, padding=1)
        self.pose_2 = nn.Conv2d(256, 6 * num_frames, 1)

    def forward(self, last_feature: torch.Tensor):
        x = F.relu(self.squeeze(last_feature))
        x = F.relu(self.pose_0(x))
        x = F.relu(self.pose_1(x))
        x = self.pose_2(x).mean(dim=(2, 3))
        x = 0.01 * x.reshape(-1, self.num_frames, 1, 6)
        return x[..., :3], x[..., 3:]
