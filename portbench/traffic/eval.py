"""The eval traffic's batch maker: a pool of distinct host batches for
``engine/train.make_eval_step``'s step: 'rgb' [B, H, W, 3] uint8 and the
ground truth 'depth' [B, Hg, Wg, 1] float32 at its own resolution, valid
on a ``gt_density`` share of its pixels, between 5 and 75 m.

Parameters: ``batch``, ``shape`` [H, W], ``gt_shape`` [Hg, Wg],
``gt_density``, ``pool``.
"""

from __future__ import annotations

from portbench.traffic import scene


def make_pool(params: dict, seed: int, device) -> list:
    gen = scene.generator(seed, device)
    b, (h, w) = params["batch"], params["shape"]
    gh, gw = params["gt_shape"]
    pool = []
    for _ in range(params["pool"]):
        rgb, _ = scene.frames(gen, b, h, w, 0)
        depth = scene.sparse_depth(gen, b, gh, gw, params["gt_density"], (5.0, 20.0), (10.0, 55.0))
        pool.append({"rgb": rgb, "depth": depth.cpu().numpy()})
    return pool


def images(params: dict) -> int:
    """Images one step evaluates (each also flipped inside the step)."""
    return params["batch"]
