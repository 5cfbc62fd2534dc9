"""Self-supervised multiview photometric loss, NHWC (port of
``losses/photometric.py``): per-scale view-synthesis warp, L1 + SSIM blend,
optional std clipping, min/mean reduction across contexts (+ the automask
identity-reprojection terms), edge-aware smoothness.

With ``clip_loss == 0`` the contexts (and their identity terms) are stacked
on the batch axis, so each scale runs one warp and one L1 + SSIM chain;
``clip_loss`` pools its statistics per map and takes the per-context path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from packnet_sfm_tpu_torch.geometry.camera import Camera, scale_intrinsics, view_synthesis
from packnet_sfm_tpu_torch.losses.smoothness import smoothness_loss
from packnet_sfm_tpu_torch.ops.image import match_scales
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


def multiview_photometric_loss(
    image: torch.Tensor,
    context: Sequence[torch.Tensor],
    inv_depths: Sequence[torch.Tensor],
    K: torch.Tensor,
    poses: Sequence[torch.Tensor],
    cfg: MultiViewPhotometricConfig,
    ref_K: Optional[torch.Tensor] = None,
):
    """The self-supervised photometric loss: (loss, metrics).

    image: [B, H, W, 3] target frame (un-jittered original); context: list of
    [B, H, W, 3] context frames; inv_depths: list of [B, Hs, Ws, 1]
    multi-scale inverse depths of the target; K: [B, 3, 3] intrinsics
    (``ref_K`` defaults to K); poses: list of [B, 4, 4] target->context
    transforms, one per context.
    """
    if ref_K is None:
        ref_K = K
    n = cfg.num_scales
    inv_depths = list(inv_depths)[:n]
    full_w = image.shape[2]
    shapes = [tuple(d.shape[1:3]) for d in inv_depths]
    images = match_scales(image, shapes)
    depths = [inv2depth(d) for d in inv_depths]
    K, ref_K = K.float(), ref_K.float()

    # photometric_losses[i] collects [B, Hs, Ws, 1] maps across contexts
    # (+ identity terms when automasking), then reduces with min/mean.
    photometric_losses = [[] for _ in range(n)]
    n_ctx = len(context)
    b = image.shape[0]
    if cfg.clip_loss == 0.0:
        poses_2 = torch.cat(list(poses), dim=0)                  # [n_ctx*B,4,4]
        for i in range(n):
            sf = shapes[i][1] / float(full_w)
            K_s = scale_intrinsics(K, sf)
            refK_s = scale_intrinsics(ref_K, sf)
            refs2 = torch.cat([match_scales(r, [shapes[i]])[0] for r in context], dim=0)
            depth2 = torch.cat([depths[i]] * n_ctx, dim=0)
            cam2 = Camera(K=torch.cat([K_s] * n_ctx, dim=0))
            ref_cam2 = Camera(K=torch.cat([refK_s] * n_ctx, dim=0), Tcw=poses_2)
            warped2 = view_synthesis(refs2, depth2, ref_cam2, cam2,
                                     padding_mode=cfg.padding_mode)
            est = torch.cat([warped2, refs2], dim=0) if cfg.automask_loss else warped2
            reps = est.shape[0] // b
            pm = _photometric_map(est, torch.cat([images[i]] * reps, dim=0), cfg)
            photometric_losses[i] = [pm[k * b:(k + 1) * b] for k in range(reps)]
    else:
        cams = [Camera(K=scale_intrinsics(K, w / float(full_w))) for (_, w) in shapes]
        for ref_image, pose in zip(context, poses):
            for i in range(n):
                sf = shapes[i][1] / float(full_w)
                ref_cam = Camera(K=scale_intrinsics(ref_K, sf), Tcw=pose)
                warped = view_synthesis(match_scales(ref_image, [shapes[i]])[0], depths[i],
                                        ref_cam, cams[i], padding_mode=cfg.padding_mode)
                photometric_losses[i].append(_photometric_map(warped, images[i], cfg))
            if cfg.automask_loss:
                ref_scaled = match_scales(ref_image, shapes)
                for i in range(n):
                    photometric_losses[i].append(
                        _photometric_map(ref_scaled[i], images[i], cfg))

    def reduce_one(losses: list) -> torch.Tensor:
        if cfg.photometric_reduce_op == "mean":
            return sum(l.mean() for l in losses) / len(losses)
        if cfg.photometric_reduce_op == "min":
            return torch.cat(losses, dim=-1).min(dim=-1).values.mean()
        raise ValueError(f"Unknown photometric_reduce_op {cfg.photometric_reduce_op}")

    photometric_loss = sum(reduce_one(photometric_losses[i]) for i in range(n)) / n
    metrics = {"photometric_loss": photometric_loss}
    loss = photometric_loss
    if cfg.smooth_loss_weight > 0.0:
        s_loss = smoothness_loss(inv_depths, images, cfg.smooth_loss_weight)
        metrics["smoothness_loss"] = s_loss
        loss = loss + s_loss
    return loss, metrics
