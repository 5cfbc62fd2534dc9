"""Plain PyTorch networks of the benchmark's configurations: PackNet01 (and
its slim form, for the CPU tests), PoseNet, PackNet-SAN01 with its sparse
lidar branch.

Written from the published descriptions (PackNet-SfM, CVPR 2020; PackNet-SAN,
CVPR 2021) in plain PyTorch, with no kernel, fusion or layout trick:
the pack layer is space-to-depth, an ``nn.Conv3d``-style 3x3x3 convolution
over the packed channels, the channel fold and a 2D convolution, in that
order. Parameter names follow the program's state dict, so that the
benchmark can hand both sides the same weights; nothing here imports the
program.

Every convolution takes its input and weights through ``self.cast``
(identity by default). ``set_precision`` sets it on every convolution of a
model to round to a lower precision: that is how the control of
``portbench/correct.py`` computes the reference in the precision below the
configuration's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input, weight and output pass through ``cast``."""

    cast: Callable = staticmethod(_identity)

    def forward(self, x):
        c = self.cast
        return c(self._conv_forward(c(x.to(self.weight.dtype)), c(self.weight), self.bias))


class ChannelConv3d(nn.Module):
    """Conv3d(1, d, 3, padding 1) over [B, 1, C, H, W], folded to
    [B, d*C, H, W] (channel j*C + c)."""

    cast: Callable = staticmethod(_identity)

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, 1, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        b, c, h, w = x.shape
        cast = self.cast
        y = cast(F.conv3d(cast(x.unsqueeze(1)), cast(self.weight), self.bias, padding=1))
        return y.reshape(b, -1, h, w)


def set_precision(model: nn.Module, cast: Optional[Callable]) -> None:
    """Route every convolution of ``model`` through ``cast`` (None: exact)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ChannelConv3d)):
            m.cast = cast or _identity


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int = 16):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, 1e-5)


class Conv2dBlock(nn.Module):
    """Conv (zero pad k // 2) + GroupNorm(16) + ELU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=k // 2)
        self.norm = GroupNorm(cout)

    def forward(self, x):
        return F.elu(self.norm(self.conv(x)))


class ResidualConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(cin, cout, 3)
        self.Conv2dBlock_1 = Conv2dBlock(cout, cout, 3)
        self.conv = Conv2d(cin, cout, 1)
        self.norm = GroupNorm(cout)

    def forward(self, x):
        return F.elu(self.norm(self.Conv2dBlock_1(self.Conv2dBlock_0(x)) + self.conv(x)))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"ResidualConv_{i}", ResidualConv(cin if i == 0 else cout, cout))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"ResidualConv_{i}")(x)
        return x


class PackLayer(nn.Module):
    """Space-to-depth by 2, the 3D conv over the packed channels, the fold,
    then a Conv2dBlock."""

    def __init__(self, c: int, k: int, d: int):
        super().__init__()
        self.conv = ChannelConv3d(d)
        self.Conv2dBlock_0 = Conv2dBlock(c * 4 * d, c, k)

    def forward(self, x):
        return self.Conv2dBlock_0(self.conv(F.pixel_unshuffle(x, 2)))


class UnpackLayer(nn.Module):
    """Conv2dBlock, the 3D conv, then depth-to-space by 2."""

    def __init__(self, cin: int, c: int, d: int):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(cin, c * 4 // d, 3)
        self.conv = ChannelConv3d(d)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(self.Conv2dBlock_0(x)), 2)


class InvDepthHead(nn.Module):
    """3x3 conv, sigmoid, over min_depth 0.5."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv = Conv2d(cin, 1, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(self.conv(x)) / 0.5


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Encoder(nn.Module):
    """The PackNet encoder: NCHW rgb -> (x5p, [x, x1p, x2p, x3p, x4p])."""

    def __init__(self, ni: int, channels, d: int):
        super().__init__()
        n1, n2, n3, n4, n5 = channels
        self.pre_calc = Conv2dBlock(3, ni, 5)
        self.conv1 = Conv2dBlock(ni, n1, 7)
        self.pack1 = PackLayer(n1, 5, d)
        self.conv2 = ResidualBlock(n1, n2, 2)
        self.pack2 = PackLayer(n2, 3, d)
        self.conv3 = ResidualBlock(n2, n3, 2)
        self.pack3 = PackLayer(n3, 3, d)
        self.conv4 = ResidualBlock(n3, n4, 3)
        self.pack4 = PackLayer(n4, 3, d)
        self.conv5 = ResidualBlock(n4, n5, 3)
        self.pack5 = PackLayer(n5, 3, d)

    def forward(self, x):
        x = self.pre_calc(x)
        x1p = self.pack1(self.conv1(x))
        x2p = self.pack2(self.conv2(x1p))
        x3p = self.pack3(self.conv3(x2p))
        x4p = self.pack4(self.conv4(x3p))
        return self.pack5(self.conv5(x4p)), [x, x1p, x2p, x3p, x4p]


class Decoder(nn.Module):
    """The PackNet decoder, version A (skips concatenated): -> four NCHW
    inverse depths, finest first."""

    def __init__(self, ni: int, channels, d: int):
        super().__init__()
        n1, n2, n3, n4, n5 = channels
        self.unpack5 = UnpackLayer(n5, n5, d)
        self.iconv5 = Conv2dBlock(n5 + n4, n5, 3)
        self.unpack4 = UnpackLayer(n5, n4, d)
        self.iconv4 = Conv2dBlock(n4 + n3, n4, 3)
        self.disp4 = InvDepthHead(n4)
        self.unpack3 = UnpackLayer(n4, n3, d)
        self.iconv3 = Conv2dBlock(n3 + n2 + 1, n3, 3)
        self.disp3 = InvDepthHead(n3)
        self.unpack2 = UnpackLayer(n3, n2, d)
        self.iconv2 = Conv2dBlock(n2 + n1 + 1, n2, 3)
        self.disp2 = InvDepthHead(n2)
        self.unpack1 = UnpackLayer(n2, n1, d)
        self.iconv1 = Conv2dBlock(n1 + ni + 1, n1, 3)
        self.disp1 = InvDepthHead(n1)

    def forward(self, x5p, skips):
        s1, s2, s3, s4, s5 = skips
        i5 = self.iconv5(torch.cat([self.unpack5(x5p), s5], 1))
        i4 = self.iconv4(torch.cat([self.unpack4(i5), s4], 1))
        d4 = self.disp4(i4)
        i3 = self.iconv3(torch.cat([self.unpack3(i4), s3, up2(d4)], 1))
        d3 = self.disp3(i3)
        i2 = self.iconv2(torch.cat([self.unpack2(i3), s2, up2(d3)], 1))
        d2 = self.disp2(i2)
        i1 = self.iconv1(torch.cat([self.unpack1(i2), s1, up2(d2)], 1))
        return [self.disp1(i1), d2, d3, d4]


class PackNet(nn.Module):
    """PackNet01-1A (ni 64, channels 64-512, d 8) or PackNetSlim01-1A (ni 32,
    n1 32, d 4): NHWC rgb -> four NHWC inverse depths. The program names
    the encoder's and decoder's layers at the top level, as here."""

    def __init__(self, slim: bool = False):
        super().__init__()
        ni, channels, d = (32, (32, 64, 128, 256, 512), 4) if slim else (64, (64, 64, 128, 256, 512), 8)
        enc, dec = Encoder(ni, channels, d), Decoder(ni, channels, d)
        self._enc, self._dec = [enc], [dec]     # held without registering them twice
        for name, m in list(enc.named_children()) + list(dec.named_children()):
            self.add_module(name, m)

    def forward(self, rgb):
        x5p, skips = self._enc[0](rgb.permute(0, 3, 1, 2))
        return [t.permute(0, 2, 3, 1) for t in self._dec[0](x5p, skips)]


class PoseNet(nn.Module):
    """Seven stride-2 conv + GroupNorm(16) + ReLU stages over concat(target,
    contexts), a 1x1 head, the spatial mean: 0.01 * [B, n_ctx, 6]."""

    CHANNELS = (16, 32, 64, 128, 256, 256, 256)
    KERNELS = (7, 5, 3, 3, 3, 3, 3)

    def __init__(self, n_ctx: int = 2):
        super().__init__()
        self.n_ctx = n_ctx
        cin = 3 * (1 + n_ctx)
        for i, (c, k) in enumerate(zip(self.CHANNELS, self.KERNELS)):
            stage = nn.Module()
            stage.conv = Conv2d(cin, c, k, stride=2, padding=(k - 1) // 2)
            stage.norm = GroupNorm(c)
            self.add_module(f"conv{i + 1}", stage)
            cin = c
        self.pose_pred = Conv2d(cin, 6 * n_ctx, 1)

    def forward(self, image, context):
        x = torch.cat([image] + list(context), dim=-1).permute(0, 3, 1, 2)
        for i in range(len(self.CHANNELS)):
            stage = getattr(self, f"conv{i + 1}")
            x = F.relu(stage.norm(stage.conv(x)))
        x = self.pose_pred(x).mean(dim=(2, 3))
        return 0.01 * x.reshape(x.shape[0], self.n_ctx, 6)


# ---- PackNet-SAN's sparse branch, densely with a validity mask ----------

class MaskedBatchNorm(nn.Module):
    """Batch norm with statistics over the active sites (training only)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, mask):
        n = mask.sum().clamp(min=1.0)
        mean = (x * mask).sum((0, 2, 3)) / n
        var = (((x - mean.view(1, -1, 1, 1)) ** 2) * mask).sum((0, 2, 3)) / n
        out = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + 1e-5)
        return (out * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)) * mask


class SparseConv(nn.Module):
    def __init__(self, cin: int, c: int, k: int):
        super().__init__()
        self.conv = Conv2d(cin, c, k, padding=k // 2)

    def forward(self, x, mask):
        return self.conv(x * mask) * mask


class SparseConvBlock(nn.Module):
    """Masked max pool (3, stride 2), then three sparse-conv paths (1, 2, 3
    convs) summed, batch norm and ReLU on the active sites."""

    def __init__(self, cin: int, f: int, k: int):
        super().__init__()
        self.l1_conv0 = SparseConv(cin, f, k)
        self.l2_conv0 = SparseConv(cin, 2 * f, k)
        self.l2_bn0 = MaskedBatchNorm(2 * f)
        self.l2_conv1 = SparseConv(2 * f, f, k)
        self.l3_conv0 = SparseConv(cin, 2 * f, k)
        self.l3_bn0 = MaskedBatchNorm(2 * f)
        self.l3_conv1 = SparseConv(2 * f, 2 * f, k)
        self.l3_bn1 = MaskedBatchNorm(2 * f)
        self.l3_conv2 = SparseConv(2 * f, f, k)
        self.final_bn = MaskedBatchNorm(f)

    def forward(self, x, mask):
        xm = torch.where(mask > 0, x, torch.finfo(x.dtype).min)
        pooled = F.max_pool2d(xm, 3, 2, 1)
        mask = F.max_pool2d(mask, 3, 2, 1)
        x = torch.where(mask > 0, pooled, 0.0)

        def bn_relu(bn, t):
            return F.relu(bn(t, mask)) * mask

        x1 = self.l1_conv0(x, mask)
        x2 = self.l2_conv1(bn_relu(self.l2_bn0, self.l2_conv0(x, mask)), mask)
        x3 = bn_relu(self.l3_bn0, self.l3_conv0(x, mask))
        x3 = self.l3_conv2(bn_relu(self.l3_bn1, self.l3_conv1(x3, mask)), mask)
        return bn_relu(self.final_bn, x1 + x2 + x3), mask


class PackNetSAN(nn.Module):
    """PackNetSAN01-1A: the slim encoder and decoder, and the sparse branch
    whose features join the skips with a learned weight and bias a level.
    Training with input depth: the rgb pass, then the rgb+d pass, and the
    feature consistency between them."""

    CHANNELS = (32, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.encoder = Encoder(32, self.CHANNELS, 4)
        self.decoder = Decoder(32, self.CHANNELS, 4)
        self.mconvs = nn.Module()
        cin = 1
        for i, (c, k) in enumerate(zip(self.CHANNELS, (5, 5, 3, 3, 3))):
            self.mconvs.add_module(f"block{i}", SparseConvBlock(cin, c, k))
            cin = c
        self.weight = nn.Parameter(torch.ones(5))
        self.bias = nn.Parameter(torch.zeros(5))

    def _decode(self, x5p, skips, sfeats=None):
        if sfeats is not None:
            skips = [skips[0]] + [s * self.weight[i] + f + self.bias[i]
                                  for i, (s, f) in enumerate(zip(skips[1:], sfeats))]
            x5p = x5p * self.weight[4] + sfeats[4] + self.bias[4]
        disps = [d.permute(0, 2, 3, 1) for d in self.decoder(x5p, skips)]
        return disps, list(skips) + [x5p]

    def forward(self, rgb, input_depth=None):
        x5p, skips = self.encoder(rgb.permute(0, 3, 1, 2))
        if input_depth is None:
            return {"inv_depths": self._decode(x5p, skips)[0]}
        depth = input_depth.permute(0, 3, 1, 2)
        mask = (depth > 0).to(depth.dtype)
        feats, sfeats = depth * mask, []
        for i in range(5):
            feats, mask = getattr(self.mconvs, f"block{i}")(feats, mask)
            sfeats.append(feats)
        inv_rgb, f_rgb = self._decode(x5p, skips)
        inv_rgbd, f_rgbd = self._decode(x5p, skips, sfeats)
        depth_loss = sum(torch.mean((a.detach() - b) ** 2) for a, b in zip(f_rgbd, f_rgb)) / len(f_rgb)
        return {"inv_depths": inv_rgb, "inv_depths_rgbd": inv_rgbd, "depth_loss": depth_loss}
