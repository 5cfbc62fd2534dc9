"""Supervised inverse-depth losses (port of ``losses/supervised.py``),
NHWC: l1, mse, berhu, silog and abs_rel, each also with the ``sparse-``
prefix that masks pixels whose ground truth is 0. Every method is a
mask-weighted reduction over static shapes, as the JAX package writes it:
each one is computed from a few sums over the batch's pixels (and BerHu's
threshold from a max).

With more than one rank (``group``, the ranks that share the global batch)
those sums and the max are taken over every rank's pixels, as the JAX
package's step over a globally sharded batch takes them: every rank
computes the global batch's loss, and its gradient reaches each rank's
pixels through the sums (``parallel/spatial.share``). Given a ``band``
(``parallel/spatial.Band``) the predictions are this rank's bands of rows
and the ground truth whole: it is brought to each scale's whole shape and
the band's rows taken, and the loss is this band's share (the whole loss
over the band count; the shares sum to it over the space group).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from packnet_sfm_tpu_torch.ops.image import interpolate_image
from packnet_sfm_tpu_torch.parallel import spatial


@dataclasses.dataclass(frozen=True)
class SupervisedLossConfig:
    supervised_method: str = "sparse-l1"
    supervised_num_scales: int = 4


# Each method: (the sums over the pixels, stacked; the loss from the sums).
def _masked_mean(x: torch.Tensor, mask: torch.Tensor):
    return (torch.stack([torch.sum(x * mask), torch.sum(mask)]),
            lambda t: t[0] / torch.clamp(t[1], min=1.0))


def _loss_l1(pred, gt, mask, group):
    return _masked_mean(torch.abs(pred - gt), mask)


def _loss_mse(pred, gt, mask, group):
    return _masked_mean((pred - gt) ** 2, mask)


def _loss_abs_rel(pred, gt, mask, group):
    # mean(|x - y| / x) with x the prediction, as the reference writes it
    return _masked_mean(torch.abs(pred - gt) / torch.clamp(pred, min=1e-6), mask)


def _loss_berhu(pred, gt, mask, group, threshold: float = 0.2):
    """BerHu: the mean over concat(|d|, d^2 where |d| > c), c = threshold *
    max(pred - gt), as (sum |d| + sum d^2 [|d| > c]) / (N + M)."""
    diff = pred - gt
    huber_c = threshold * spatial.max_over(diff * mask, group)
    adiff = torch.abs(diff) * mask
    over = (adiff > huber_c).to(pred.dtype) * mask
    sums = torch.stack([torch.sum(adiff), torch.sum(adiff ** 2 * over), torch.sum(mask),
                        torch.sum(over)])
    return sums, lambda t: (t[0] + t[1]) / torch.clamp(t[2] + t[3], min=1.0)


def _loss_silog(pred, gt, mask, group, ratio: float = 10.0, ratio2: float = 0.85):
    """Scale-invariant log loss."""
    log_diff = (torch.log(torch.clamp(pred * ratio, min=1e-9))
                - torch.log(torch.clamp(gt * ratio, min=1e-9))) * mask

    def loss(t):
        n = torch.clamp(t[2], min=1.0)
        silog1 = t[0] / n
        silog2 = ratio2 * (t[1] / n) ** 2
        return torch.sqrt(torch.clamp(silog1 - silog2, min=1e-12)) * ratio

    return torch.stack([torch.sum(log_diff ** 2), torch.sum(log_diff), torch.sum(mask)]), loss


METHODS = {
    "l1": _loss_l1,
    "mse": _loss_mse,
    "berhu": _loss_berhu,
    "silog": _loss_silog,
    "abs_rel": _loss_abs_rel,
}


def supervised_loss(inv_depths: Sequence[torch.Tensor], gt_inv_depth: torch.Tensor,
                    cfg: SupervisedLossConfig, band: Optional[spatial.Band] = None,
                    group=None):
    """Multi-scale supervised loss on inverse depth: the mean over the
    first ``supervised_num_scales`` predictions [B, Hs, Ws, 1], the ground
    truth [B, H, W, 1] brought to each by nearest resize. Returns (loss,
    {'supervised_loss': loss}). ``band``, ``group``: see the module
    docstring."""
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
        h, w = pred.shape[1:3]
        gt = interpolate_image(gt_inv_depth, (h if band is None else band.rows(h), w),
                               mode="nearest")
        if band is not None:
            gt = band.take(gt)
        mask = (gt > 0).to(pred.dtype) if sparse else torch.ones_like(gt)
        sums, loss_fn = fn(pred, gt, mask, group)
        total = total + spatial.share(loss_fn, sums, group, band)
    loss = total / n
    return loss, {"supervised_loss": loss}
