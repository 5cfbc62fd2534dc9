"""PoseResNet (port of ``nn/pose_resnet.py``): a two-image ResNet encoder
and the monodepth2 pose decoder. For each context frame the encoder takes
concat(target, context) (6 channels) and the decoder gives a 6-DoF vector;
the output is [B, n_context, 6] ordered [translation | axisangle], the
[t | r] order that ``geometry/pose.pose_vec_to_mat`` takes.

The ResNet family takes no compute dtype (``nn/resnet.py``): PoseResNet
computes in float32 on any input, as the JAX package builds it.
"""

from __future__ import annotations

import torch
from torch import nn

from packnet_sfm_tpu_torch.nn.resnet import PoseDecoder, ResNetEncoder, init_decoder_weights


class PoseResNet(nn.Module):
    def __init__(self, version: str = "18"):
        super().__init__()
        # the layer count is the version's first two characters, as the JAX
        # package reads it ('18', '34', '50'; '18pt' arrives as '18')
        self.encoder = ResNetEncoder(num_layers=int(version[:2]), num_input_images=2)
        self.decoder = PoseDecoder(self.encoder.num_ch_enc[-1], num_frames=2)

    def init_weights(self, gen: torch.Generator) -> None:
        self.encoder.init_weights(gen)
        init_decoder_weights(self.decoder, gen)

    def forward(self, image: torch.Tensor, context: list) -> torch.Tensor:
        """image and each context [B, H, W, 3] -> [B, len(context), 6]."""
        outs = []
        for ref in context:
            feats = self.encoder(torch.cat([image, ref], dim=-1).permute(0, 3, 1, 2))
            axisangle, translation = self.decoder(feats[-1])
            outs.append(torch.cat([translation[:, 0], axisangle[:, 0]], dim=-1))
        return torch.cat(outs, dim=1).reshape(image.shape[0], len(context), 6)
