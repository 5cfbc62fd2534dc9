"""The ego-motion pipeline (port of ``packnet_sfm_tpu/egomotion/
odometry.py``): PoseNet odometry, then the optional refinements.

1. The model's pose net predicts frame-to-frame transforms over a sequence,
   in batches of ``batch_pairs`` pairs (the last batch padded by repeating
   its last pair, as in the JAX package).
2. Direct photometric alignment refines each relative pose against the
   predicted depth of its target frame (``egomotion/alignment.py``).
3. Overlapping keyframe windows are refined by the Schur-complement pose
   graph (``egomotion/posegraph.py``) and spliced back into the trajectory.
4. ATE/RPE against KITTI odometry ground truth (``egomotion/
   evaluation.py``).

The networks run where the model's weights are; frames come in as numpy
[N, H, W, 3] float32 and poses go out as numpy [.., 4, 4].
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.egomotion.alignment import refine_pose_photometric
from packnet_sfm_tpu_torch.egomotion.posegraph import (
    PoseGraphConfig,
    chain_relative_poses,
    optimize_pose_graph,
)
from packnet_sfm_tpu_torch.models.sfm import model_forward


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _pair_poses(model, targets: np.ndarray, refs: np.ndarray, batch_pairs: int) -> np.ndarray:
    """Target->context poses of the pairs (targets[k], refs[k]), in
    batches of ``batch_pairs``; the last padded with its last pair."""
    dev, out = _device(model), []
    for s in range(0, len(targets), batch_pairs):
        t, r = targets[s:s + batch_pairs], refs[s:s + batch_pairs]
        pad = batch_pairs - len(t)
        if pad:
            t = np.concatenate([t, np.repeat(t[-1:], pad, 0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, 0)])
        t, r = torch.from_numpy(t).to(dev), torch.from_numpy(r).to(dev)
        with torch.no_grad():
            Z = model_forward(model, {"rgb": t, "rgb_context": [r, r]}, train=False)["poses"][0]
        out.append(Z.cpu().numpy()[:batch_pairs - pad])
    return np.concatenate(out, axis=0)


def predict_relative_poses(model, frames: np.ndarray, batch_pairs: int = 8) -> np.ndarray:
    """Z_{k,k+1} for consecutive frames [N, H, W, 3] -> [N-1, 4, 4]: the
    pose net with frame k as target and frame k+1 as context (target->
    context)."""
    return _pair_poses(model, frames[:-1], frames[1:], batch_pairs)


def predict_skip_poses(model, frames: np.ndarray, stride: int = 2,
                       batch_pairs: int = 8) -> List[tuple]:
    """Independent pose measurements of the (k, k+stride) frame pairs, which
    the pose net sees as pairs (not compositions of the consecutive
    predictions), as [(i, j, Z, w = 0.7), ...] for
    ``refine_trajectory_windowed(extra_edges=...)``."""
    n = frames.shape[0]
    if n <= stride:
        return []
    ks = np.arange(0, n - stride)
    Z = _pair_poses(model, frames[ks], frames[ks + stride], batch_pairs)
    return [(int(k), int(k) + stride, Z[c], 0.7) for c, k in enumerate(ks)]


def refine_relative_poses(model, frames: np.ndarray, intrinsics: np.ndarray,
                          relative: np.ndarray, num_iterations: int = 8) -> np.ndarray:
    """Direct-alignment refinement of each relative pose, with the predicted
    depth of its target frame (one depth forward a target frame)."""
    dev, out = _device(model), []
    K = torch.from_numpy(np.asarray(intrinsics)[None]).to(dev)
    for k in range(frames.shape[0] - 1):
        target = torch.from_numpy(frames[k:k + 1]).to(dev)
        ref = torch.from_numpy(frames[k + 1:k + 2]).to(dev)
        with torch.no_grad():
            inv_depth = model_forward(model, {"rgb": target}, train=False)["inv_depths"][0]
        T, _ = refine_pose_photometric(target, ref, inv_depth, K,
                                       torch.from_numpy(np.asarray(relative[k])).to(dev),
                                       num_iterations=num_iterations)
        out.append(T.cpu().numpy())
    return np.stack(out)


def trajectory_from_relative(relative: np.ndarray) -> np.ndarray:
    """Chain [N-1, 4, 4] relative poses into a [N, 4, 4] trajectory."""
    return chain_relative_poses(torch.from_numpy(np.asarray(relative))).numpy()


def window_edges(relative: np.ndarray, s: int, e: int,
                 extra_edges: Optional[List[tuple]] = None) -> dict:
    """The pose-graph edges of the window [s, e) as numpy arrays {'i', 'j',
    'Z', 'w'}, numbered within the window: its odometry edges (weight 1),
    and the ``extra_edges`` (i, j, Z, w) that fall inside it; where none are
    given, composed skip-2 edges (weight 0.5) stand in as a smoothness
    prior, since they carry no new information."""
    ii, jj, Zs, ws = [], [], [], []
    for k in range(s, e - 1):
        ii.append(k - s); jj.append(k - s + 1); Zs.append(relative[k]); ws.append(1.0)
    if not extra_edges:
        for k in range(s, e - 2):
            ii.append(k - s); jj.append(k - s + 2); Zs.append(relative[k] @ relative[k + 1])
            ws.append(0.5)
    for (i, j, Z, w) in extra_edges or []:
        if s <= i < e and s <= j < e:
            ii.append(i - s); jj.append(j - s); Zs.append(Z); ws.append(w)
    return {"i": np.asarray(ii, np.int64), "j": np.asarray(jj, np.int64),
            "Z": np.stack(Zs).astype(np.float32), "w": np.asarray(ws, np.float32)}


def refine_trajectory_windowed(
    trajectory: np.ndarray,
    relative: np.ndarray,
    window: int = 10,
    overlap: int = 4,
    extra_edges: Optional[List[tuple]] = None,
    cfg: PoseGraphConfig = PoseGraphConfig(optimize_scales=False),
    device="cuda",
) -> np.ndarray:
    """Refine a long trajectory with overlapping pose-graph windows, each
    solved on ``device`` against its ``window_edges``; the refined segment
    is rigidly re-anchored at the window's first frame, and the next window
    starts ``overlap`` frames before its end."""
    dev = resolve_device(device)
    n = trajectory.shape[0]
    out = trajectory.copy()
    s = 0
    while s < n - 1:
        e = min(s + window, n)
        idx = np.arange(s, e)
        edges = {k: torch.from_numpy(v).to(dev)
                 for k, v in window_edges(relative, s, e, extra_edges).items()}
        T_win, _, _ = optimize_pose_graph(
            torch.from_numpy(out[idx].astype(np.float32)).to(dev), edges, cfg)
        T_win = T_win.cpu().numpy()
        # splice: re-anchor at the window's start
        anchor = out[s] @ np.linalg.inv(T_win[0])
        out[idx] = np.einsum("ij,njk->nik", anchor, T_win)
        if e == n:
            break
        s = e - overlap
    return out
