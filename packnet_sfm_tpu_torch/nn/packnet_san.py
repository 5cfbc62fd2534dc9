"""PackNet-SAN, the CVPR'21 Sparse Auxiliary Network (port of
``nn/packnet_san.py``): a PackNetSlim-style encoder and decoder (version A),
and a sparse lidar branch (``nn/sparse.py``) whose densified features join
the skip pyramid with a learned scalar weight and bias a level.

Training with ``input_depth`` runs two decoder passes: rgb alone, then
rgb + depth, and returns {'inv_depths', 'inv_depths_rgbd', 'depth_loss'},
where 'depth_loss' is the feature consistency: the mean of (f_rgbd -
f_rgb)^2 over each of the five features, f_rgbd held constant, divided by
5. The rgb encoder runs once and feeds both passes: the JAX package calls
it twice on the same image, with the same outputs (GroupNorm keeps no
statistics and dropout does not train) and so the same gradient sum. In
eval one pass, with the depth where it is given.

The JAX package builds PackNetSAN01 without a compute dtype, so every layer
here is dtype-less too: a bfloat16 image or depth meets the float32
weights in float32 (``nn/layers.py``). The pack and unpack layers are
``nn/packnet.py``'s. Networks take NHWC rgb [B, H, W, 3] and depth [B, H,
W, 1] and return NHWC inverse depths; inside they run NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from packnet_sfm_tpu_torch.nn.layers import (
    Conv2dBlock,
    InvDepthHead,
    ResidualBlock,
    init_conv_weights,
)
from packnet_sfm_tpu_torch.nn.packnet import (
    PackLayerConv3d,
    UnpackLayerConv3d,
    _upsample2_nearest,
)
from packnet_sfm_tpu_torch.nn.sparse import SparseDepthEncoder

CHANNELS = (32, 64, 128, 256, 512)


class SANEncoder(nn.Module):
    """The PackNetSlim encoder half: NCHW rgb -> (x5p, [x, x1p, x2p, x3p,
    x4p])."""

    def __init__(self, ni: int = 32, channels=CHANNELS, num_blocks=(2, 2, 3, 3), d: int = 4,
                 dropout: Optional[float] = None):
        super().__init__()
        n1, n2, n3, n4, n5 = channels
        pack_kernel = (5, 3, 3, 3, 3)

        def pack(c, k):
            return PackLayerConv3d(c, k, d=d)

        self.pre_calc = Conv2dBlock(3, ni, 5, 1)
        self.conv1 = Conv2dBlock(ni, n1, 7, 1)
        self.pack1 = pack(n1, pack_kernel[0])
        self.conv2 = ResidualBlock(n1, n2, num_blocks[0], 1, dropout)
        self.pack2 = pack(n2, pack_kernel[1])
        self.conv3 = ResidualBlock(n2, n3, num_blocks[1], 1, dropout)
        self.pack3 = pack(n3, pack_kernel[2])
        self.conv4 = ResidualBlock(n3, n4, num_blocks[2], 1, dropout)
        self.pack4 = pack(n4, pack_kernel[3])
        self.conv5 = ResidualBlock(n4, n5, num_blocks[3], 1, dropout)
        self.pack5 = pack(n5, pack_kernel[4])

    def forward(self, rgb: torch.Tensor):
        x = self.pre_calc(rgb)
        x1p = self.pack1(self.conv1(x))
        x2p = self.pack2(self.conv2(x1p))
        x3p = self.pack3(self.conv3(x2p))
        x4p = self.pack4(self.conv4(x3p))
        x5p = self.pack5(self.conv5(x4p))
        return x5p, [x, x1p, x2p, x3p, x4p]


class SANDecoder(nn.Module):
    """The PackNetSlim decoder half, version A (skips concatenated): (x5p,
    skips) -> [disp1 (full res), disp2, disp3, disp4], NCHW."""

    def __init__(self, version: str = "A", ni: int = 32, channels=CHANNELS, d: int = 4,
                 out_channels: int = 1):
        super().__init__()
        if version != "A":
            raise ValueError("PackNetSAN supports version A")
        n1, n2, n3, n4, n5 = channels
        no = out_channels
        self.unpack5 = UnpackLayerConv3d(n5, n5, 3, d=d)
        self.iconv5 = Conv2dBlock(n5 + n4, n5, 3, 1)
        self.unpack4 = UnpackLayerConv3d(n5, n4, 3, d=d)
        self.iconv4 = Conv2dBlock(n4 + n3, n4, 3, 1)
        self.disp4 = InvDepthHead(n4, no)
        self.unpack3 = UnpackLayerConv3d(n4, n3, 3, d=d)
        self.iconv3 = Conv2dBlock(n3 + n2 + no, n3, 3, 1)
        self.disp3 = InvDepthHead(n3, no)
        self.unpack2 = UnpackLayerConv3d(n3, n2, 3, d=d)
        self.iconv2 = Conv2dBlock(n2 + n1 + no, n2, 3, 1)
        self.disp2 = InvDepthHead(n2, no)
        self.unpack1 = UnpackLayerConv3d(n2, n1, 3, d=d)
        self.iconv1 = Conv2dBlock(n1 + ni + no, n1, 3, 1)
        self.disp1 = InvDepthHead(n1, no)

    def forward(self, x5p: torch.Tensor, skips) -> list:
        skip1, skip2, skip3, skip4, skip5 = skips
        iconv5 = self.iconv5(torch.cat([self.unpack5(x5p), skip5], 1))
        iconv4 = self.iconv4(torch.cat([self.unpack4(iconv5), skip4], 1))
        disp4 = self.disp4(iconv4)
        iconv3 = self.iconv3(torch.cat([self.unpack3(iconv4), skip3,
                                        _upsample2_nearest(disp4)], 1))
        disp3 = self.disp3(iconv3)
        iconv2 = self.iconv2(torch.cat([self.unpack2(iconv3), skip2,
                                        _upsample2_nearest(disp3)], 1))
        disp2 = self.disp2(iconv2)
        iconv1 = self.iconv1(torch.cat([self.unpack1(iconv2), skip1,
                                        _upsample2_nearest(disp2)], 1))
        disp1 = self.disp1(iconv1)
        return [disp1, disp2, disp3, disp4]


class PackNetSAN01(nn.Module):
    """The full PackNet-SAN: rgb [B, H, W, 3] (+ input_depth [B, H, W, 1])
    -> a dict (see the module docstring)."""

    def __init__(self, version: str = "A", dropout: Optional[float] = None):
        super().__init__()
        self.encoder = SANEncoder(dropout=dropout)
        self.decoder = SANDecoder(version=version)
        self.mconvs = SparseDepthEncoder(CHANNELS)
        self.weight = nn.Parameter(torch.ones(5))
        self.bias = nn.Parameter(torch.zeros(5))

    def init_weights(self, gen: torch.Generator) -> None:
        """flax xavier-uniform kernels and zero biases for the PackNet
        layers, the sparse convs and their batch norms alike (flax's
        ``nn.Conv`` there takes the same initializer); the level weights 1,
        biases 0."""
        init_conv_weights(self.encoder, gen)
        init_conv_weights(self.decoder, gen)
        init_conv_weights(self.mconvs, gen)

    def _decode(self, x5p: torch.Tensor, skips: list, sfeats: Optional[list] = None):
        """One decoder pass over the encoder's outputs, the sparse features
        joined to them first where given -> (NHWC inverse depths, the five
        features)."""
        if sfeats is not None:
            skips = [skips[0]] + [s * self.weight[i] + f + self.bias[i]
                                  for i, (s, f) in enumerate(zip(skips[1:], sfeats))]
            x5p = x5p * self.weight[4] + sfeats[4] + self.bias[4]
        disps = [d.permute(0, 2, 3, 1) for d in self.decoder(x5p, skips)]
        return disps, list(skips) + [x5p]

    def forward(self, rgb: torch.Tensor, input_depth: Optional[torch.Tensor] = None) -> dict:
        x5p, skips = self.encoder(rgb.permute(0, 3, 1, 2))
        sfeats = None
        if input_depth is not None:
            with record_function("sparse_branch"):
                sfeats = self.mconvs(input_depth.permute(0, 3, 1, 2))
        if not self.training:
            return {"inv_depths": self._decode(x5p, skips, sfeats)[0]}
        inv_depths, feat_rgb = self._decode(x5p, skips)
        out = {"inv_depths": inv_depths}
        if sfeats is None:
            return out
        out["inv_depths_rgbd"], feat_rgbd = self._decode(x5p, skips, sfeats)
        out["depth_loss"] = sum(torch.mean((f_rgbd.detach() - f_rgb) ** 2)
                                for f_rgbd, f_rgb in zip(feat_rgbd, feat_rgb)) / len(feat_rgbd)
        return out
