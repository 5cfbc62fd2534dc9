"""Offline depth-map comparison CLI (port of
``packnet_sfm_tpu/cli/evaluate_depth_maps.py``)::

    python -m packnet_sfm_tpu_torch.cli.evaluate_depth_maps --pred_folder <dir>
        --gt_folder <dir> [--use_gt_scale] [--min_depth 0] [--max_depth 80]
        [--crop garg] [--device cuda|cpu]

Pairs the npz/png depth maps of two folders in sorted order and prints the
mean of the 7 depth metrics over the pairs. The metrics are computed on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Offline depth map evaluation")
    p.add_argument("--pred_folder", type=str, required=True)
    p.add_argument("--gt_folder", type=str, required=True)
    p.add_argument("--use_gt_scale", action="store_true")
    p.add_argument("--min_depth", type=float, default=0.0)
    p.add_argument("--max_depth", type=float, default=80.0)
    p.add_argument("--crop", type=str, default="", choices=["", "garg"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def evaluate_folders(pred_folder: str, gt_folder: str, use_gt_scale: bool = False,
                     min_depth: float = 0.0, max_depth: float = 80.0,
                     crop: str = "", device="cuda") -> np.ndarray:
    """The mean [7] metrics over the folders' pairs of depth maps."""
    import torch

    from packnet_sfm_tpu_torch.device import resolve_device
    from packnet_sfm_tpu_torch.engine.metrics import DepthMetricsConfig, compute_depth_metrics
    from packnet_sfm_tpu_torch.utils.save import load_depth

    device = resolve_device(device)
    exts = (".npz", ".png")
    preds = sorted(f for f in os.listdir(pred_folder) if f.endswith(exts))
    gts = sorted(f for f in os.listdir(gt_folder) if f.endswith(exts))
    if len(preds) != len(gts):
        raise ValueError(f"Wrong number of predicted depth maps: {len(preds)} predicted, "
                         f"{len(gts)} ground truth")
    cfg = DepthMetricsConfig(crop=crop, min_depth=min_depth, max_depth=max_depth)
    total = np.zeros(7)
    for pf, gf in zip(preds, gts):
        pred = torch.from_numpy(load_depth(os.path.join(pred_folder, pf))[None, ..., None])
        gt = torch.from_numpy(load_depth(os.path.join(gt_folder, gf))[None, ..., None])
        metrics = compute_depth_metrics(gt.to(device), pred.to(device), cfg,
                                        use_gt_scale=use_gt_scale)
        total += metrics.cpu().numpy()
    return total / len(preds)


def main(argv=None):
    from packnet_sfm_tpu_torch.engine.metrics import METRIC_NAMES

    args = parse_args(argv)
    total = evaluate_folders(args.pred_folder, args.gt_folder, args.use_gt_scale,
                             args.min_depth, args.max_depth, args.crop, args.device)
    print("| " + " | ".join(f"{n:>8}" for n in METRIC_NAMES) + " |")
    print("| " + " | ".join(f"{v:8.3f}" for v in total) + " |")
    return total


if __name__ == "__main__":
    main()
