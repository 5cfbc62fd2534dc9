"""Disparity scaling of the ResNet depth nets (port of ``nn/depth_resnet.py``).

This slice ports ``disp_to_depth``; ``DepthResNet`` comes with the ResNet
family (ROADMAP.md).
"""

from __future__ import annotations

import torch


def disp_to_depth(disp: torch.Tensor, min_depth: float = 0.1, max_depth: float = 100.0):
    """Sigmoid disp -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp
