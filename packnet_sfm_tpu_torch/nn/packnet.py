"""PackNet depth networks (port of ``packnet_sfm_tpu/nn/packnet.py``).

encoder = pre_calc Conv(5) -> [conv_i (residual) -> pack_i] x5; decoder = 5
unpack stages with skip concat (version A) or add (B) + iconv + 4 inverse
depth heads. The pack layer is space-to-depth, a 3x3x3 conv over the packed
channels and a 2D conv (fused into one convolution where it pays:
``ops/fold_conv.fused_pack_conv``); the unpack layer is a 2D conv, the 3D
conv and depth-to-space.

The networks take NHWC images and return NHWC inverse depths; inside they
run NCHW. Submodules are named after the flax module tree (``pre_calc``,
``conv1``, ``pack1``, ..., and inside them ``conv`` for ``Conv_0``,
``Conv2dBlock_0``, ``ResidualConv_0``, ...), so ``utils/convert.from_jax``
maps weights by name. ``remat=True`` recomputes the pack, unpack, full
Conv2dBlock and head sub-blocks in the backward with
``torch.utils.checkpoint``. ``dtype`` is the compute dtype of every layer
(``nn/layers.py``); the inverse depths come out in float32 whatever it is.

On a band of rows (``parallel/spatial.py``) the pack convolutions take
the two-step path (``ops/fold_conv.fused_pack_conv``); packing, unpacking
and the nearest upsample are local to a band whose row start is even at
every level, which a height divisible by the band count times
``space_stride`` gives.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from packnet_sfm_tpu_torch.nn.layers import (
    Conv2dBlock,
    InvDepthHead,
    ResidualBlock,
    init_conv_weights,
)
from packnet_sfm_tpu_torch.ops.fold_conv import channel_conv3d, fused_pack_conv
from packnet_sfm_tpu_torch.ops.image import interpolate_image
from packnet_sfm_tpu_torch.parallel import spatial


class ChannelConv3d(nn.Module):
    """3x3x3 conv over (channel-as-depth, H, W) emitting the folded layout:
    [B, Cp, H, W] -> [B, d*Cp, H, W], folded channel j*Cp + c. Parameters
    ``weight`` [d, 1, 3, 3, 3] and ``bias`` [d], as ``nn.Conv3d(1, d, 3)``.
    Computes in ``dtype``, or else the input's, as the JAX module does."""

    def __init__(self, d: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d, 1, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(d))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = channel_conv3d(x.permute(0, 2, 3, 1), self.weight, self.bias,
                           self.dtype or x.dtype)
        return y.permute(0, 3, 1, 2)


class PackLayerConv3d(nn.Module):
    """Pack: space-to-depth -> 3D conv over packed channels -> 2D conv
    (+ GroupNorm + ELU). [B, C, H, W] -> [B, C, H/2, W/2].

    With ``fuse=True`` the linear conv3d, fold, conv2d composition goes
    through ``fused_pack_conv`` (``mode``: auto | fused | two_step); the
    parameters are the same either way.
    """

    def __init__(self, features: int, kernel_size: int, r: int = 2, d: int = 8,
                 fuse: bool = True, mode: str = "auto", dtype=None):
        super().__init__()
        self.r, self.fuse, self.mode, self.dtype = r, fuse, mode, dtype
        self.conv = ChannelConv3d(d, dtype)
        self.Conv2dBlock_0 = Conv2dBlock(features * r * r * d, features, kernel_size, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        band = spatial.current()
        if band is not None and band.start(x.shape[2]) % self.r:
            raise ValueError(f"packing by {self.r} a band that starts at row "
                             f"{band.start(x.shape[2])}")
        x = F.pixel_unshuffle(x, self.r)                      # [B, C*r*r, H/r, W/r]
        block = self.Conv2dBlock_0
        if not self.fuse:
            return block(self.conv(x))
        y = fused_pack_conv(x.permute(0, 2, 3, 1), self.conv.weight, self.conv.bias,
                            block.conv.weight, block.conv.bias, mode=self.mode,
                            dtype=self.dtype or x.dtype)
        return F.elu(block.norm(y.permute(0, 3, 1, 2)))


class UnpackLayerConv3d(nn.Module):
    """Unpack: 2D conv -> 3D conv -> depth-to-space upsample.
    [B, Cin, H, W] -> [B, features, rH, rW]."""

    def __init__(self, cin: int, features: int, kernel_size: int, r: int = 2, d: int = 8,
                 dtype=None):
        super().__init__()
        self.r = r
        self.Conv2dBlock_0 = Conv2dBlock(cin, features * r * r // d, kernel_size, 1, dtype)
        self.conv = ChannelConv3d(d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(self.Conv2dBlock_0(x)), self.r)


def _upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample of NCHW, by ``ops/image.interpolate_image``."""
    up = interpolate_image(x.permute(0, 2, 3, 1), (2 * x.shape[2], 2 * x.shape[3]),
                           mode="nearest")
    return up.permute(0, 3, 1, 2)


class PackNetBase(nn.Module):
    """Shared PackNet01/Slim01 topology; the channel plan is set by the
    subclass. version: 'A' (skip concat) or 'B' (skip add)."""

    ni: int = 64
    channels: Tuple[int, int, int, int, int] = (64, 64, 128, 256, 512)
    num_blocks: Tuple[int, int, int, int] = (2, 2, 3, 3)
    num_3d_feat: int = 8
    # five packs by 2: a height divisible by bands x 32 leaves every band a row
    space_stride: int = 32

    def __init__(self, version: str = "A", dropout: Optional[float] = None,
                 out_channels: int = 1, remat: bool = False, fuse: bool = True,
                 pack_mode: str = "auto", dtype=None):
        super().__init__()
        self.version, self.remat, self.dtype = version, remat, dtype
        v, no, ni, d = version, out_channels, self.ni, self.num_3d_feat
        n1, n2, n3, n4, n5 = self.channels
        pack_kernel = (5, 3, 3, 3, 3)
        if v == "A":    # concat skips
            n1o, n1i = n1, n1 + ni + no
            n2o, n2i = n2, n2 + n1 + no
            n3o, n3i = n3, n3 + n2 + no
            n4o, n4i = n4, n4 + n3
            n5o, n5i = n5, n5 + n4
        elif v == "B":  # add skips
            n1o, n1i = n1, n1 + no
            n2o, n2i = n2, n2 + no
            n3o, n3i = n3 // 2, n3 // 2 + no
            n4o, n4i = n4 // 2, n4 // 2
            n5o, n5i = n5 // 2, n5 // 2
        else:
            raise ValueError(f"Unknown PackNet version {v}")

        def pack(c, k):
            return PackLayerConv3d(c, k, d=d, fuse=fuse, mode=pack_mode, dtype=dtype)

        def unpack(cin, c):
            return UnpackLayerConv3d(cin, c, 3, d=d, dtype=dtype)

        def block(cin, c, k):
            return Conv2dBlock(cin, c, k, 1, dtype)

        def residual(cin, c, n):
            return ResidualBlock(cin, c, n, 1, dropout, dtype)

        self.pre_calc = block(3, ni, 5)
        self.conv1 = block(ni, n1, 7)
        self.pack1 = pack(n1, pack_kernel[0])
        self.conv2 = residual(n1, n2, self.num_blocks[0])
        self.pack2 = pack(n2, pack_kernel[1])
        self.conv3 = residual(n2, n3, self.num_blocks[1])
        self.pack3 = pack(n3, pack_kernel[2])
        self.conv4 = residual(n3, n4, self.num_blocks[2])
        self.pack4 = pack(n4, pack_kernel[3])
        self.conv5 = residual(n4, n5, self.num_blocks[3])
        self.pack5 = pack(n5, pack_kernel[4])

        self.unpack5 = unpack(n5, n5o)
        self.iconv5 = block(n5i, n5, 3)
        self.unpack4 = unpack(n5, n4o)
        self.iconv4 = block(n4i, n4, 3)
        self.disp4 = InvDepthHead(n4, no, dtype=dtype)
        self.unpack3 = unpack(n4, n3o)
        self.iconv3 = block(n3i, n3, 3)
        self.disp3 = InvDepthHead(n3, no, dtype=dtype)
        self.unpack2 = unpack(n3, n2o)
        self.iconv2 = block(n2i, n2, 3)
        self.disp2 = InvDepthHead(n2, no, dtype=dtype)
        self.unpack1 = unpack(n2, n1o)
        self.iconv1 = block(n1i, n1, 3)
        self.disp1 = InvDepthHead(n1, no, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        init_conv_weights(self, gen)

    def _run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Submodule ``name`` on x; recomputed in the backward under remat,
        on the band in effect now (the recomputation runs in the backward,
        outside it)."""
        module = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            band = spatial.current()
            return checkpoint(module, x, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), spatial.use(band)))
        return module(x)

    def forward(self, rgb: torch.Tensor) -> list:
        """rgb [B, H, W, 3] -> [disp1 (full res), disp2, disp3, disp4], each
        [B, Hs, Ws, 1] inverse depth."""
        run = self._run
        x = run("pre_calc", rgb.permute(0, 3, 1, 2))

        x1 = run("conv1", x)
        x1p = run("pack1", x1)
        x2p = run("pack2", self.conv2(x1p))
        x3p = run("pack3", self.conv3(x2p))
        x4p = run("pack4", self.conv4(x3p))
        x5p = run("pack5", self.conv5(x4p))
        skip1, skip2, skip3, skip4, skip5 = x, x1p, x2p, x3p, x4p

        concat = self.version == "A"

        def merge(up, skip, udisp=None):
            parts = [up, skip] if concat else [up + skip]
            if udisp is not None:
                # the next conv rounds the float32 inverse depth to the
                # compute dtype; rounding it before the concat is the same
                parts.append(udisp if self.dtype is None else udisp.to(self.dtype))
            return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

        iconv5 = run("iconv5", merge(run("unpack5", x5p), skip5))
        iconv4 = run("iconv4", merge(run("unpack4", iconv5), skip4))
        disp4 = run("disp4", iconv4)
        iconv3 = run("iconv3", merge(run("unpack3", iconv4), skip3, _upsample2_nearest(disp4)))
        disp3 = run("disp3", iconv3)
        iconv2 = run("iconv2", merge(run("unpack2", iconv3), skip2, _upsample2_nearest(disp3)))
        disp2 = run("disp2", iconv2)
        iconv1 = run("iconv1", merge(run("unpack1", iconv2), skip1, _upsample2_nearest(disp2)))
        disp1 = run("disp1", iconv1)
        return [d.permute(0, 2, 3, 1) for d in (disp1, disp2, disp3, disp4)]


class PackNet01(PackNetBase):
    """PackNet01: ni=64, channels (64, 64, 128, 256, 512), d=8."""


class PackNetSlim01(PackNetBase):
    """PackNetSlim01: ni=32, n1=32, d=4."""

    ni = 32
    channels = (32, 64, 128, 256, 512)
    num_3d_feat = 4
