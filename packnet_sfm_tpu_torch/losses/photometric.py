"""Photometric loss pieces, NHWC (port of ``losses/photometric.py``).

This slice ports the configuration, ``inv2depth`` and the per-pixel
L1 + SSIM map with its std clipping; the pinhole multiview loss comes with
the PackNet01 slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

from packnet_sfm_tpu_torch.ops.ssim import ssim_loss


@dataclasses.dataclass(frozen=True)
class MultiViewPhotometricConfig:
    """Loss knobs, as in the JAX package."""

    num_scales: int = 4
    ssim_loss_weight: float = 0.85
    smooth_loss_weight: float = 0.001
    C1: float = 1e-4
    C2: float = 9e-4
    photometric_reduce_op: str = "min"
    clip_loss: float = 0.0
    automask_loss: bool = True
    padding_mode: str = "zeros"

    def __post_init__(self):
        if self.automask_loss and self.photometric_reduce_op != "min":
            raise ValueError("automasking requires photometric_reduce_op='min'")


def inv2depth(inv_depth: torch.Tensor) -> torch.Tensor:
    """Invert inverse depth with a 1e-6 clamp."""
    return 1.0 / inv_depth.clamp(min=1e-6)


def _photometric_map(est: torch.Tensor, ref: torch.Tensor,
                     cfg: MultiViewPhotometricConfig) -> torch.Tensor:
    """Per-pixel L1 + SSIM photometric residual [B, H, W, 1], then the
    optional clip at mean + clip_loss * std (std with ddof 0, as jnp.std)."""
    l1 = torch.mean(torch.abs(est - ref), dim=-1, keepdim=True)
    if cfg.ssim_loss_weight > 0.0:
        s = torch.mean(ssim_loss(est, ref, cfg.C1, cfg.C2), dim=-1, keepdim=True)
        loss = cfg.ssim_loss_weight * s + (1.0 - cfg.ssim_loss_weight) * l1
    else:
        loss = torch.abs(est - ref)
    if cfg.clip_loss > 0.0:
        bound = loss.mean() + cfg.clip_loss * loss.std(correction=0)
        loss = torch.minimum(loss, bound)
    return loss
