"""The train traffic's batch maker: a pool of distinct host batches, each
as the loader hands it to ``engine/train.make_train_step``'s step ('rgb'
[B, H, W, 3] uint8, 'rgb_context' a list of them, 'intrinsics', 'jitter'
[B, 4]; for completion 'depth' and 'input_depth' [B, H, W, 1] float32).

Parameters (a traffic file's keys): ``batch``, ``shape`` [H, W],
``contexts``, ``jitter`` (the recipe's four ranges, or null), ``pool``
(batches made), and for depth completion ``gt_density`` and
``input_density`` (shares of the pixels with ground truth and with input
depth; the input depth is the ground truth on a subset of its pixels).
The samples' contrasts rise over the batch (``scene.textures``), so that a
step that trains on part of its batch reads a loss of its own.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import scene


def make_pool(params: dict, seed: int, device) -> list:
    gen = scene.generator(seed, device)
    b, (h, w) = params["batch"], params["shape"]
    pool = []
    for _ in range(params["pool"]):
        rgb, ctx = scene.frames(gen, b, h, w, params.get("contexts", 0), ordered=True)
        batch = {"rgb": rgb}
        if ctx:
            batch["rgb_context"] = ctx
            batch["intrinsics"] = scene.intrinsics(b, h, w)
        if params.get("jitter"):
            batch["jitter"] = scene.jitter_factors(gen, b, params["jitter"])
        if params.get("gt_density"):
            gt = scene.sparse_depth(gen, b, h, w, params["gt_density"])
            keep = scene.rand(gen, *gt.shape) < params["input_density"] / params["gt_density"]
            batch["depth"] = gt.cpu().numpy()
            batch["input_depth"] = (gt * keep).cpu().numpy().astype(np.float32)
        pool.append(batch)
    return pool


def images(params: dict) -> int:
    """Images one step trains on."""
    return params["batch"]
