"""RaySurfaceResNet: depth + learned ray-surface residual for NRS (port of
``nn/raysurface.py``): a shared ResNet encoder, the monodepth2 depth decoder
and a tanh 3-channel ray-surface decoder at full resolution.
"""

from __future__ import annotations

import torch
from torch import nn

from packnet_sfm_tpu_torch.engine import spans
from packnet_sfm_tpu_torch.nn.depth_resnet import disp_to_depth
from packnet_sfm_tpu_torch.nn.resnet import (
    Conv3x3Refl,
    DepthDecoder,
    ResNetEncoder,
    init_decoder_weights,
    parse_resnet_version,
)


class RaySurfaceDecoder(DepthDecoder):
    """The DepthDecoder trunk without disp heads; tanh, 3 channels, scale 0."""

    def __init__(self, num_ch_enc):
        super().__init__(num_ch_enc, heads=False)
        self.raysurfconv_0 = Conv3x3Refl(self.num_ch_dec[0], 3)

    def forward(self, features: list) -> torch.Tensor:
        *_, (_, x) = self._trunk(features)
        return torch.tanh(self.raysurfconv_0(x))


class RaySurfaceResNet(nn.Module):
    """rgb [B, H, W, 3] -> {'inv_depths': 4 scales [B, Hs, Ws, 1] finest
    first, 'ray_surface': [B, H, W, 3]} (NHWC at the boundary). On a band
    of rows (``parallel/spatial.py``) both decoders run on the band as
    DepthResNet's does: their reflection pads take the rows across its
    edges from the neighbouring bands. The ray-surface decoder runs under
    the span ``ray_decoder`` (``engine/spans.py``)."""

    # the encoder's stride, as DepthResNet's: a band keeps a row at 1/32
    space_stride = 32

    def __init__(self, version: str = "18", min_depth: float = 0.1,
                 max_depth: float = 100.0):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.encoder = ResNetEncoder(num_layers=parse_resnet_version(version))
        self.decoder = DepthDecoder(self.encoder.num_ch_enc)
        self.ray_decoder = RaySurfaceDecoder(self.encoder.num_ch_enc)

    def init_weights(self, gen: torch.Generator) -> None:
        self.encoder.init_weights(gen)
        init_decoder_weights(self.decoder, gen)
        init_decoder_weights(self.ray_decoder, gen)

    def forward(self, rgb: torch.Tensor) -> dict:
        feats = self.encoder(rgb.permute(0, 3, 1, 2))
        disps = self.decoder(feats)
        with spans.span("ray_decoder"):
            rays = self.ray_decoder(feats)
        inv_depths = [disp_to_depth(d, self.min_depth, self.max_depth)[0].permute(0, 2, 3, 1)
                      for d in disps]
        return {"inv_depths": inv_depths, "ray_surface": rays.permute(0, 2, 3, 1)}
