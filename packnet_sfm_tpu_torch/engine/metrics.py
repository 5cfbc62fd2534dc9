"""Depth evaluation metrics (port of ``packnet_sfm_tpu/engine/metrics.py``).

7 metrics (abs_rel, sqr_rel, rmse, rmse_log, a1, a2, a3), the Garg crop,
min/max-depth validity masking, ground-truth median scaling, and the flip
post-processing fusion. The JAX package's ``vmap`` over samples is batched
tensor ops over [B, N] here; invalid pixels are masked by weights (no
boolean indexing, so nothing waits for the host), and the masked median is
the exact lower median of a sort with invalid entries pushed to +inf, the
same element the JAX package picks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.ops.image import flip_lr, interpolate_image

METRIC_NAMES = ("abs_rel", "sqr_rel", "rmse", "rmse_log", "a1", "a2", "a3")


@dataclasses.dataclass(frozen=True)
class DepthMetricsConfig:
    """Mirrors the reference's model.params."""

    crop: str = "garg"
    min_depth: float = 0.0
    max_depth: float = 80.0
    scale_output: str = "resize"


def _masked_lower_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact lower median of each row of ``values`` where ``mask`` > 0.

    values/mask: [B, N]. Invalid entries sort to +inf; the lower median is
    element max((n - 1) // 2, 0) of the sorted row, n its valid count (a row
    with none gives +inf, which the caller selects away). Returns [B].
    """
    big = torch.full((), float("inf"), dtype=values.dtype, device=values.device)
    sorted_vals = torch.sort(torch.where(mask > 0, values, big), dim=-1).values
    n = mask.sum(dim=-1).to(torch.int64)
    idx = torch.clamp((n - 1) // 2, min=0)
    return sorted_vals.gather(-1, idx[:, None])[:, 0]


def garg_crop_mask(h: int, w: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Garg crop rectangle as a [H, W] mask (reference utils/depth.py:286-290)."""
    y1, y2 = int(0.40810811 * h), int(0.99189189 * h)
    x1, x2 = int(0.03594771 * w), int(0.96405229 * w)
    m = torch.zeros((h, w), dtype=dtype, device=device)
    m[y1:y2, x1:x2] = 1.0
    return m


def compute_depth_metrics_per_sample(gt: torch.Tensor, pred: torch.Tensor,
                                     cfg: DepthMetricsConfig,
                                     use_gt_scale: bool = True) -> torch.Tensor:
    """Per-sample 7 depth metrics, [B, 7] (no batch reduction).

    gt/pred: [B, H, W, 1] depth maps; pred is brought to gt's resolution,
    by the align-corners bilinear resize ('resize') or by padding it at the
    bottom centre ('top-center'). A sample with no valid pixel gives a zero
    row.
    """
    b, h, w, _ = gt.shape
    if tuple(pred.shape[1:3]) != (h, w):
        if cfg.scale_output == "top-center":
            top = h - pred.shape[1]
            left = (w - pred.shape[2]) // 2
            pred = F.pad(pred, (0, 0, left, w - pred.shape[2] - left,
                                top, h - pred.shape[1] - top))
        else:
            pred = interpolate_image(pred, (h, w), mode="bilinear")

    gt_f = gt[..., 0].reshape(b, -1)
    pred_f = pred[..., 0].reshape(b, -1)
    valid = ((gt_f > cfg.min_depth) & (gt_f < cfg.max_depth)).to(gt.dtype)
    if cfg.crop == "garg":
        valid = valid * garg_crop_mask(h, w, gt.dtype, gt.device).reshape(1, -1)

    count = valid.sum(dim=1)
    n = torch.clamp(count, min=1.0)
    if use_gt_scale:
        med_gt = _masked_lower_median(gt_f, valid)
        med_pred = _masked_lower_median(pred_f, valid)
        pred_f = pred_f * med_gt[:, None] / torch.clamp(med_pred, min=1e-6)[:, None]
    pred_f = torch.clamp(pred_f, cfg.min_depth, cfg.max_depth)
    one = torch.ones((), dtype=gt.dtype, device=gt.device)
    gt_safe = torch.where(valid > 0, gt_f, one)
    pred_safe = torch.where(valid > 0, pred_f, one)

    thresh = torch.maximum(gt_safe / pred_safe, pred_safe / gt_safe)
    a1 = ((thresh < 1.25) * valid).sum(dim=1) / n
    a2 = ((thresh < 1.25 ** 2) * valid).sum(dim=1) / n
    a3 = ((thresh < 1.25 ** 3) * valid).sum(dim=1) / n
    diff = (gt_safe - pred_safe) * valid
    abs_rel = (diff.abs() / gt_safe).sum(dim=1) / n
    sq_rel = (diff ** 2 / gt_safe).sum(dim=1) / n
    rmse = torch.sqrt((diff ** 2).sum(dim=1) / n)
    rmse_log = torch.sqrt(
        (((torch.log(gt_safe) - torch.log(pred_safe)) * valid) ** 2).sum(dim=1) / n)
    m = torch.stack([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3], dim=1)
    return torch.where((count > 0)[:, None], m, torch.zeros_like(m))


def compute_depth_metrics(gt: torch.Tensor, pred: torch.Tensor, cfg: DepthMetricsConfig,
                          use_gt_scale: bool = True) -> torch.Tensor:
    """Batch mean of the 7 depth metrics, [7]."""
    return compute_depth_metrics_per_sample(gt, pred, cfg, use_gt_scale).mean(dim=0)


def fuse_inv_depth(inv_depth: torch.Tensor, inv_depth_hat: torch.Tensor,
                   method: str = "mean") -> torch.Tensor:
    """Fuse straight and flipped inverse depths (reference utils/depth.py:201)."""
    if method == "mean":
        return 0.5 * (inv_depth + inv_depth_hat)
    if method == "max":
        return torch.maximum(inv_depth, inv_depth_hat)
    if method == "min":
        return torch.minimum(inv_depth, inv_depth_hat)
    raise ValueError(f"Unknown post-process method {method}")


def post_process_inv_depth(inv_depth: torch.Tensor, inv_depth_flipped: torch.Tensor,
                           method: str = "mean") -> torch.Tensor:
    """Flip-fusion post-process with 20*(x-0.05) border ramps
    (reference utils/depth.py:229-255). Inputs [B, H, W, 1]."""
    w = inv_depth.shape[2]
    inv_depth_hat = flip_lr(inv_depth_flipped)
    fused = fuse_inv_depth(inv_depth, inv_depth_hat, method=method)
    # i / (w - 1) in the inputs' dtype: jnp.linspace(0, 1, w)'s values
    xs = (torch.arange(w, dtype=inv_depth.dtype, device=inv_depth.device)
          / (w - 1)).reshape(1, 1, w, 1)
    mask = 1.0 - torch.clamp(20.0 * (xs - 0.05), 0.0, 1.0)
    mask_hat = mask.flip(2)
    return (mask_hat * inv_depth + mask * inv_depth_hat
            + (1.0 - mask - mask_hat) * fused)
