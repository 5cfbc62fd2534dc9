"""Ego-motion CLI (port of ``packnet_sfm_tpu/cli/odometry.py``): predict and
refine a trajectory over an image sequence::

    python -m packnet_sfm_tpu_torch.cli.odometry --checkpoint <dir> \\
        --input <frames_dir> [--gt poses.txt] [--output pred.txt] \\
        [--refine-direct] [--refine-ba] [--window N] [--max-frames N] \\
        [--image_shape H W] [--device cuda|cpu]

PoseNet odometry over consecutive frames, optional direct photometric
refinement of each pair (``--refine-direct``, with the ``warp_jvp`` kernel
on the card) and windowed pose-graph BA (``--refine-ba``, with skip-2 and
skip-3 pose measurements as extra edges), the trajectory written in KITTI
odometry format, and ATE/RPE against ``--gt`` printed as one JSON line.
The model is built in float32 whatever the checkpoint's ``arch.dtype``
says, as the JAX CLI builds it. Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PackNet-SfM odometry (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--input", type=str, required=True, help="folder of ordered frames")
    p.add_argument("--output", type=str, default=None, help="KITTI-format poses txt to write")
    p.add_argument("--gt", type=str, default=None, help="ground-truth KITTI odometry poses txt")
    p.add_argument("--image_shape", type=int, nargs=2, default=None)
    p.add_argument("--refine-direct", action="store_true",
                   help="direct photometric pose refinement per pair")
    p.add_argument("--refine-ba", action="store_true", help="windowed pose-graph refinement")
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def kitti_intrinsics(h: int, w: int) -> np.ndarray:
    """The JAX CLI's normalized KITTI-like intrinsics for an h x w frame."""
    return np.array([[0.58 * w, 0, w / 2 - 0.5],
                     [0, 1.92 * h, h / 2 - 0.5],
                     [0, 0, 1]], np.float32)


def load_frames(input_dir: str, shape=None, max_frames: int = 0) -> np.ndarray:
    """The folder's frames in name order, resized to ``shape`` where given
    -> [N, H, W, 3] float32 in [0, 1]."""
    from packnet_sfm_tpu_torch.datasets.augmentations import resize_image
    from packnet_sfm_tpu_torch.datasets.kitti import load_image

    exts = (".png", ".jpg", ".jpeg")
    files = sorted(os.path.join(input_dir, f) for f in os.listdir(input_dir)
                   if f.lower().endswith(exts))
    if max_frames:
        files = files[:max_frames]
    return np.stack([resize_image(load_image(f), shape) if shape else load_image(f)
                     for f in files])


def run_odometry(checkpoint, input_dir, output=None, gt=None, image_shape=None,
                 refine_direct=False, refine_ba=False, window=10, max_frames=0,
                 device="cuda"):
    """The trajectory [N, 4, 4] of the folder's frames; writes ``output`` and
    prints the ATE/RPE line against ``gt`` where given."""
    from packnet_sfm_tpu_torch.core.config import ConfigNode
    from packnet_sfm_tpu_torch.egomotion.evaluation import (
        absolute_trajectory_error, load_kitti_odometry_poses, relative_pose_error,
        save_kitti_odometry_poses)
    from packnet_sfm_tpu_torch.egomotion.odometry import (
        predict_relative_poses, predict_skip_poses, refine_relative_poses,
        refine_trajectory_windowed, trajectory_from_relative)
    from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint
    from packnet_sfm_tpu_torch.engine.factory import setup_model

    with open(os.path.join(checkpoint, "meta.json")) as f:
        meta = json.load(f)
    config = ConfigNode.from_dict(meta["config"])
    model = setup_model(config.model, device=device)
    restore_checkpoint(checkpoint, model)

    shape = image_shape or tuple(config.datasets.augmentation.image_shape) or None
    frames = load_frames(input_dir, shape, max_frames)
    h, w = frames.shape[1:3]
    K = kitti_intrinsics(h, w)

    rel = predict_relative_poses(model, frames)
    if refine_direct:
        rel = refine_relative_poses(model, frames, K, rel)
    traj = trajectory_from_relative(rel)
    if refine_ba:
        # independent skip-stride measurements give the window graph real
        # averaging power over the chained odometry's drift
        extra = (predict_skip_poses(model, frames, stride=2)
                 + predict_skip_poses(model, frames, stride=3))
        traj = refine_trajectory_windowed(traj, rel, window=window, extra_edges=extra,
                                          device=device)

    if output:
        save_kitti_odometry_poses(output, traj)
        print(f"wrote {len(traj)} poses -> {output}")
    if gt:
        gt_poses = load_kitti_odometry_poses(gt)[:len(traj)]
        ate = absolute_trajectory_error(traj, gt_poses, align_scale=True)
        rpe_t, rpe_r = relative_pose_error(traj, gt_poses)
        print(json.dumps({"ate_rmse_m": round(ate, 4), "rpe_trans_m": round(rpe_t, 4),
                          "rpe_rot_deg": round(rpe_r, 4), "frames": len(traj)}))
    return traj


def main(argv=None):
    a = parse_args(argv)
    run_odometry(a.checkpoint, a.input, a.output, a.gt, a.image_shape, a.refine_direct,
                 a.refine_ba, a.window, a.max_frames, a.device)


if __name__ == "__main__":
    main()
