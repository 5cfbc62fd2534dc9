"""Velocity (metric-scale) supervision (port of ``losses/velocity.py``):
| ||t_pred|| - ||t_gt|| |, averaged over the batch and the context frames.

On a band of rows (``parallel/spatial.Band``) the poses are whole on every
rank of the space group (the pose network runs on the whole images), so the
loss is whole there too, and this band's share is the loss over the band
count: the shares sum to it over the group, and the pose network's gradient
from them is the loss's, once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from packnet_sfm_tpu_torch.parallel import spatial


def velocity_loss(pred_poses: Sequence[torch.Tensor], gt_pose_context: Sequence[torch.Tensor],
                  band: Optional[spatial.Band] = None):
    """pred_poses, gt_pose_context: one [B, 4, 4] transform a context frame.
    Returns (loss, {'velocity_loss': loss}), the band's share on a ``band``."""
    total = 0.0
    for pred, gt in zip(pred_poses, gt_pose_context):
        pred_t = torch.linalg.norm(pred[:, :3, 3], dim=-1)
        gt_t = torch.linalg.norm(gt[:, :3, 3], dim=-1)
        total = total + torch.mean(torch.abs(pred_t - gt_t))
    loss = total / len(gt_pose_context)
    if band is not None:
        loss = loss / band.count
    return loss, {"velocity_loss": loss}
