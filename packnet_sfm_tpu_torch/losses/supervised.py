"""Supervised inverse-depth losses (port of ``losses/supervised.py``),
NHWC: l1, mse, berhu, silog and abs_rel, each also with the ``sparse-``
prefix that masks pixels whose ground truth is 0. Every method is a
mask-weighted reduction over static shapes, as the JAX package writes it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from packnet_sfm_tpu_torch.ops.image import interpolate_image


@dataclasses.dataclass(frozen=True)
class SupervisedLossConfig:
    supervised_method: str = "sparse-l1"
    supervised_num_scales: int = 4


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_l1(pred, gt, mask):
    return _masked_mean(torch.abs(pred - gt), mask)


def _loss_mse(pred, gt, mask):
    return _masked_mean((pred - gt) ** 2, mask)


def _loss_abs_rel(pred, gt, mask):
    # mean(|x - y| / x) with x the prediction, as the reference writes it
    return _masked_mean(torch.abs(pred - gt) / torch.clamp(pred, min=1e-6), mask)


def _loss_berhu(pred, gt, mask, threshold: float = 0.2):
    """BerHu: the mean over concat(|d|, d^2 where |d| > c), c = threshold *
    max(pred - gt), as (sum |d| + sum d^2 [|d| > c]) / (N + M)."""
    diff = pred - gt
    huber_c = threshold * torch.max(diff * mask)
    adiff = torch.abs(diff) * mask
    over = (adiff > huber_c).to(pred.dtype) * mask
    total = torch.sum(adiff) + torch.sum(adiff ** 2 * over)
    return total / torch.clamp(torch.sum(mask) + torch.sum(over), min=1.0)


def _loss_silog(pred, gt, mask, ratio: float = 10.0, ratio2: float = 0.85):
    """Scale-invariant log loss."""
    log_diff = (torch.log(torch.clamp(pred * ratio, min=1e-9))
                - torch.log(torch.clamp(gt * ratio, min=1e-9))) * mask
    n = torch.clamp(torch.sum(mask), min=1.0)
    silog1 = torch.sum(log_diff ** 2) / n
    silog2 = ratio2 * (torch.sum(log_diff) / n) ** 2
    return torch.sqrt(torch.clamp(silog1 - silog2, min=1e-12)) * ratio


METHODS = {
    "l1": _loss_l1,
    "mse": _loss_mse,
    "berhu": _loss_berhu,
    "silog": _loss_silog,
    "abs_rel": _loss_abs_rel,
}


def supervised_loss(inv_depths: Sequence[torch.Tensor], gt_inv_depth: torch.Tensor,
                    cfg: SupervisedLossConfig):
    """Multi-scale supervised loss on inverse depth: the mean over the
    first ``supervised_num_scales`` predictions [B, Hs, Ws, 1], the ground
    truth [B, H, W, 1] brought to each by nearest resize. Returns (loss,
    {'supervised_loss': loss})."""
    method = cfg.supervised_method
    sparse = method.startswith("sparse")
    suffix = method.split("-")[-1]
    if suffix not in METHODS:
        raise ValueError(f"Unknown supervised loss {method}")
    fn = METHODS[suffix]
    n = cfg.supervised_num_scales
    if len(inv_depths) < n:
        raise IndexError(f"{n} supervised scales, {len(inv_depths)} predictions")
    total = 0.0
    for pred in inv_depths[:n]:
        gt = interpolate_image(gt_inv_depth, pred.shape[1:3], mode="nearest")
        mask = (gt > 0).to(pred.dtype) if sparse else torch.ones_like(gt)
        total = total + fn(pred, gt, mask)
    loss = total / n
    return loss, {"supervised_loss": loss}
