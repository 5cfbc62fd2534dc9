"""DepthResNet (port of ``nn/depth_resnet.py``): the ResNet encoder and the
monodepth2 depth decoder, with the sigmoid disparities scaled to inverse
depth. The submodules keep the flax names ``encoder`` and ``decoder`` so
that ``utils/convert.from_jax`` maps the weights. Version '18' or '18pt'
(ImageNet encoder weights, grafted by ``engine/checkpoint.
load_pretrained_encoder``); only ResNet-18 is ported (``nn/resnet.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from packnet_sfm_tpu_torch.nn.resnet import DepthDecoder, ResNetEncoder, init_decoder_weights


def disp_to_depth(disp: torch.Tensor, min_depth: float = 0.1, max_depth: float = 100.0):
    """Sigmoid disp -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


class DepthResNet(nn.Module):
    """rgb [B, H, W, 3] -> 4 inverse depths [B, Hs, Ws, 1], finest first
    (NHWC at the boundary)."""

    def __init__(self, version: str = "18", min_depth: float = 0.1, max_depth: float = 100.0):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.encoder = ResNetEncoder(num_layers=int(version.rstrip("pt") or "18"))
        self.decoder = DepthDecoder()

    def init_weights(self, gen: torch.Generator) -> None:
        self.encoder.init_weights(gen)
        init_decoder_weights(self.decoder, gen)

    def forward(self, rgb: torch.Tensor) -> list:
        disps = self.decoder(self.encoder(rgb.permute(0, 3, 1, 2)))
        return [disp_to_depth(d, self.min_depth, self.max_depth)[0].permute(0, 2, 3, 1)
                for d in disps]
