"""Procedural synthetic SfM dataset for tests and benchmarks.

The port's own copy of ``packnet_sfm_tpu/datasets/synthetic.py`` (numpy
only; same samples for the same (seed, idx)).

Not present in the reference (it has no test data generator — SURVEY §4);
provides *geometry-consistent* samples: a textured scene with smooth depth,
context frames rendered by inverse-warping the target through the true depth
and a known lateral camera translation, sparse gt depth, and gt context
poses. Because photometric warp-consistency really holds, a self-supervised
model trained on this data converges to the true depth (up to scale) — the
in-environment counterpart of the reference's overfit_kitti smoke proof
(reference README.md:41-48, configs/overfit_kitti.yaml). CPU-cheap and fully
deterministic by (seed, idx).
"""

from __future__ import annotations

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Non-periodic multi-octave value-noise texture in [0, 1], [H, W, 3].

    Periodic (sinusoid) textures are a trap for photometric SfM training:
    a wrong depth whose disparity lands one texture period away matches
    photometrically, so the loss can decrease while depth diverges. Value
    noise has no repeating structure, making the photometric minimum unique.
    """
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for cell, amp in ((16, 0.45), (8, 0.3), (4, 0.15), (2, 0.1)):
        gh, gw = h // cell + 2, w // cell + 2
        grid = rng.uniform(size=(gh, gw, 3)).astype(np.float32)
        img += amp * _sample_bilinear(grid, xs / cell, ys / cell)
    img -= img.min()
    return (img / max(img.max(), 1e-6)).astype(np.float32)


def _sample_bilinear(img: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Bilinear sample img [H,W,3] at float coords (xs, ys) [H,W], edge clamp."""
    h, w = img.shape[:2]
    xs = np.clip(xs, 0, w - 1.001)
    ys = np.clip(ys, 0, h - 1.001)
    x0 = np.floor(xs).astype(np.int32)
    y0 = np.floor(ys).astype(np.int32)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    bot = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


class SyntheticSfmDataset:
    """Emits the canonical sample dict schema used by the trainer."""

    def __init__(self, length: int = 64, height: int = 64, width: int = 96,
                 seed: int = 0, train: bool = True, data_transform=None,
                 back_context: int = 1, forward_context: int = 1,
                 with_depth: bool = True, with_pose: bool = True,
                 depth_density: float = 0.2, **kwargs):
        self.length = length
        self.h, self.w = height, width
        self.seed = seed
        self.train = train
        self.data_transform = data_transform
        self.back_context = back_context
        self.n_ctx = back_context + forward_context
        self.with_depth = with_depth
        self.with_pose = with_pose
        self.depth_density = depth_density

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.h, self.w
        rgb = _texture(rng, h, w)
        f = 0.6 * w
        K = np.array([[f, 0, w / 2 - 0.5],
                      [0, f, h / 2 - 0.5],
                      [0, 0, 1]], np.float32)
        ys, xs = np.mgrid[:h, :w].astype(np.float32)
        # smooth true depth in [5, 15] m
        depth = (10.0 + 5.0 * np.sin(xs / w * 3 + ys / h * 2)).astype(np.float32)
        sample = {
            "idx": idx,
            "filename": f"synthetic_{idx:010d}",
            "rgb": rgb,
            "intrinsics": K,
        }
        if self.with_depth:
            mask = rng.uniform(size=(h, w)) < self.depth_density
            sample["depth"] = (depth * mask).astype(np.float32)[..., None]
        if self.n_ctx > 0:
            ctx, poses = [], []
            for ci in range(self.n_ctx):
                # lateral camera translation: back contexts move -x, forward
                # +x (magnitude 0.1-0.3 m). A camera shifted by tx sees the
                # scene displaced by the per-pixel stereo disparity f*tx/d —
                # render the context by inverse-warping the target texture
                # through the TRUE depth, so photometric warp-consistency
                # holds exactly (up to occlusion-free smooth-scene limits).
                sign = -1.0 if ci < self.back_context else 1.0
                # baselines big enough that disparities span ~2-14 px at
                # depth 5-15 m (sub-pixel shifts would be automasked away:
                # the identity-reprojection min would always win)
                tx = sign * 0.3 * float(rng.integers(2, 5))
                disp = f * tx / depth
                ctx.append(_sample_bilinear(rgb, xs - disp, ys))
                T = np.eye(4, dtype=np.float32)
                T[0, 3] = tx
                poses.append(T)
            sample["rgb_context"] = ctx
            if self.with_pose:
                sample["pose_context"] = poses
        if self.data_transform is not None:
            sample = self.data_transform(sample, idx=idx)
        return sample


def collate_train_batch(samples, jitter=None) -> dict:
    """Stack samples into the host batch of the train step: 'rgb'
    [B, H, W, 3], 'rgb_context' (a list of [B, H, W, 3], one per context),
    'intrinsics' [B, 3, 3] and, if given, 'jitter' [B, 4] (one row of
    factors per sample)."""
    samples = list(samples)
    n_ctx = len(samples[0]["rgb_context"])
    batch = {
        "rgb": np.stack([s["rgb"] for s in samples]),
        "rgb_context": [np.stack([s["rgb_context"][c] for s in samples])
                        for c in range(n_ctx)],
        "intrinsics": np.stack([s["intrinsics"] for s in samples]),
    }
    if jitter is not None:
        batch["jitter"] = np.stack(list(jitter)).astype(np.float32)
    return batch
