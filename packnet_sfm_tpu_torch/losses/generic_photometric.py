"""Generic (ray-surface) multiview photometric loss for NRS training (port of
``losses/generic_photometric.py``).

Same L1 + SSIM / clip / reduce / smoothness structure as the pinhole loss,
but view synthesis warps through ``GenericCamera`` ray surfaces. The
predicted ray-surface residual is blended with a canonical template,
annealed by coeff = min((100 * progress)^(4/3) / 100, 1), and re-normalized.
``progress`` and ``temperature`` are Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from packnet_sfm_tpu_torch.geometry.camera_generic import (
    GenericCamera,
    view_synthesis_generic,
)
from packnet_sfm_tpu_torch.losses.photometric import (
    MultiViewPhotometricConfig,
    _photometric_map,
    inv2depth,
)
from packnet_sfm_tpu_torch.losses.smoothness import smoothness_loss
from packnet_sfm_tpu_torch.ops.image import match_scales


@dataclasses.dataclass(frozen=True)
class GenericPhotometricConfig(MultiViewPhotometricConfig):
    """Generic-loss defaults."""

    num_scales: int = 1
    patch: int = 20


def blend_ray_surface(canonical: torch.Tensor, residual: torch.Tensor,
                      progress: float) -> torch.Tensor:
    """canonical [H, W, 3] + coeff * residual [B, H, W, 3], unit-normalized."""
    coeff = min(((100.0 * float(progress)) ** (4.0 / 3.0)) / 100.0, 1.0)
    rays = canonical[None] + coeff * residual
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp(min=1e-8)


def generic_multiview_photometric_loss(
    image: torch.Tensor,
    context: Sequence[torch.Tensor],
    inv_depths: Sequence[torch.Tensor],
    ray_surface_residual: torch.Tensor,
    canonical_rays: torch.Tensor,
    poses: Sequence[torch.Tensor],
    cfg: GenericPhotometricConfig,
    progress: float,
    temperature: float,
):
    """Returns (loss, metrics)."""
    n = cfg.num_scales
    inv_depths = list(inv_depths)[:n]
    shapes = [tuple(d.shape[1:3]) for d in inv_depths]
    images = match_scales(image, shapes)
    depths = [inv2depth(d) for d in inv_depths]

    rays = blend_ray_surface(canonical_rays, ray_surface_residual, progress)

    photometric_losses = [[] for _ in range(n)]
    for ref_image, pose in zip(context, poses):
        for i in range(n):
            cam = GenericCamera(rays=rays)
            ref_cam = GenericCamera(rays=rays, Tcw=pose)
            warped = view_synthesis_generic(
                match_scales(ref_image, [shapes[i]])[0], depths[i],
                ref_cam, cam, temperature, padding_mode=cfg.padding_mode,
                patch=cfg.patch)
            photometric_losses[i].append(_photometric_map(warped, images[i], cfg))
        if cfg.automask_loss:
            ref_scaled = match_scales(ref_image, shapes)
            for i in range(n):
                photometric_losses[i].append(
                    _photometric_map(ref_scaled[i], images[i], cfg))

    def reduce_one(losses):
        if cfg.photometric_reduce_op == "mean":
            return sum(l.mean() for l in losses) / len(losses)
        if cfg.photometric_reduce_op == "min":
            return torch.cat(losses, dim=-1).min(dim=-1).values.mean()
        raise ValueError(cfg.photometric_reduce_op)

    photometric_loss = sum(reduce_one(photometric_losses[i]) for i in range(n)) / n
    metrics = {"photometric_loss": photometric_loss}
    loss = photometric_loss
    if cfg.smooth_loss_weight > 0.0:
        s = smoothness_loss(inv_depths, images, cfg.smooth_loss_weight)
        metrics["smoothness_loss"] = s
        loss = loss + s
    return loss, metrics
