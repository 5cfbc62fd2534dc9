"""Velocity (metric-scale) supervision (port of ``losses/velocity.py``):
| ||t_pred|| - ||t_gt|| |, averaged over the batch and the context frames.
"""

from __future__ import annotations

from typing import Sequence

import torch


def velocity_loss(pred_poses: Sequence[torch.Tensor], gt_pose_context: Sequence[torch.Tensor]):
    """pred_poses, gt_pose_context: one [B, 4, 4] transform a context frame.
    Returns (loss, {'velocity_loss': loss})."""
    total = 0.0
    for pred, gt in zip(pred_poses, gt_pose_context):
        pred_t = torch.linalg.norm(pred[:, :3, 3], dim=-1)
        gt_t = torch.linalg.norm(gt[:, :3, 3], dim=-1)
        total = total + torch.mean(torch.abs(pred_t - gt_t))
    loss = total / len(gt_pose_context)
    return loss, {"velocity_loss": loss}
