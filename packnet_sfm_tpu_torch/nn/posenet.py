"""SfmLearner-style PoseNet (port of ``nn/posenet.py``): 7 stride-2
conv + GroupNorm(16) + ReLU stages over concat(target, contexts), a 1x1
head, the spatial mean in float32, then 0.01 * [B, n_ref, 6]
([tx ty tz rx ry rz] per context frame). ``dtype`` is the compute dtype
of the convolutions and group norms (``nn/layers.py``); the pose comes out
in float32 whatever it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from packnet_sfm_tpu_torch.nn.layers import Conv2d, FastGroupNorm


class _ConvGN(nn.Module):
    def __init__(self, cin: int, features: int, kernel_size: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, stride=2,
                           padding=(kernel_size - 1) // 2, compute_dtype=dtype)
        self.norm = FastGroupNorm(features, num_groups=16, epsilon=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x)))


class PoseNet(nn.Module):
    CHANNELS = (16, 32, 64, 128, 256, 256, 256)
    KERNELS = (7, 5, 3, 3, 3, 3, 3)

    def __init__(self, nb_ref_imgs: int = 2, dtype=None):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        for i, (c, k) in enumerate(zip(self.CHANNELS, self.KERNELS)):
            self.add_module(f"conv{i + 1}", _ConvGN(cin, c, k, dtype))
            cin = c
        self.pose_pred = Conv2d(cin, 6 * nb_ref_imgs, 1, compute_dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """flax xavier-uniform kernels and zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=gen)
                nn.init.zeros_(m.bias)

    def forward(self, image: torch.Tensor, context: list) -> torch.Tensor:
        """image and each context [B, H, W, 3] -> [B, nb_ref_imgs, 6]."""
        if len(context) != self.nb_ref_imgs:
            raise ValueError(f"expected {self.nb_ref_imgs} context frames, got {len(context)}")
        x = torch.cat([image] + list(context), dim=-1).permute(0, 3, 1, 2)
        for i in range(len(self.CHANNELS)):
            x = getattr(self, f"conv{i + 1}")(x)
        x = self.pose_pred(x).float().mean(dim=(2, 3))
        return 0.01 * x.reshape(x.shape[0], self.nb_ref_imgs, 6)
