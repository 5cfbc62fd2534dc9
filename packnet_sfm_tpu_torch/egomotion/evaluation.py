"""Trajectory evaluation: ATE / RPE with Umeyama alignment, and KITTI
odometry pose files (the port's own copy of ``packnet_sfm_tpu/egomotion/
evaluation.py``, numpy only). Conventions follow the KITTI odometry devkit
and the TUM evaluation scripts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_kitti_odometry_poses(path: str) -> np.ndarray:
    """KITTI odometry poses txt (12 floats/row) -> [N, 4, 4]."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    n = data.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = data
    return out


def save_kitti_odometry_poses(path: str, poses: np.ndarray):
    np.savetxt(path, np.asarray(poses)[:, :3, :].reshape(-1, 12))


def align_umeyama(pred: np.ndarray, gt: np.ndarray,
                  with_scale: bool = True) -> Tuple[np.ndarray, float]:
    """Umeyama similarity alignment of trajectories.

    pred/gt: [N, 3] positions. Returns (aligned_pred [N, 3], scale).
    """
    mu_p, mu_g = pred.mean(0), gt.mean(0)
    pc, gc = pred - mu_p, gt - mu_g
    cov = gc.T @ pc / len(pred)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_p = (pc ** 2).sum() / len(pred)
    scale = float(np.trace(np.diag(D) @ S) / var_p) if with_scale else 1.0
    t = mu_g - scale * R @ mu_p
    return (scale * (R @ pred.T)).T + t, scale


def absolute_trajectory_error(pred_poses: np.ndarray, gt_poses: np.ndarray,
                              align_scale: bool = True) -> float:
    """ATE rmse (meters) after similarity alignment of positions."""
    pred = np.asarray(pred_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    aligned, _ = align_umeyama(pred, gt, with_scale=align_scale)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def relative_pose_error(pred_poses: np.ndarray, gt_poses: np.ndarray,
                        delta: int = 1) -> Tuple[float, float]:
    """RPE: (translation rmse [m], rotation rmse [deg]) over ``delta`` steps."""
    pred = np.asarray(pred_poses)
    gt = np.asarray(gt_poses)
    t_errs, r_errs = [], []
    for k in range(len(pred) - delta):
        dp = np.linalg.inv(pred[k]) @ pred[k + delta]
        dg = np.linalg.inv(gt[k]) @ gt[k + delta]
        e = np.linalg.inv(dg) @ dp
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(cos)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
