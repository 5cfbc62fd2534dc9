"""Batch-shape utilities: the port's own copy of
``packnet_sfm_tpu/models/batch_utils.py``.

``stack_multicam_batch`` folds a multi-camera [B, N, ...] host batch into
[B*N, ...], for any B. The trainer calls it before a train or eval batch
goes to the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def stack_multicam_batch(batch: Dict) -> Dict:
    """Fold the camera axis of stacked multi-camera samples into the batch
    axis. Applies to arrays shaped [B, N, ...] where images are 5-D and
    intrinsics 4-D; context lists are folded element-wise."""
    rgb = batch.get("rgb")
    if rgb is None or rgb.ndim != 5:
        return batch
    b, n = rgb.shape[:2]

    def fold(x):
        return np.reshape(x, (b * n,) + x.shape[2:])

    out = {}
    for k, v in batch.items():
        if k == "jitter" and isinstance(v, np.ndarray) and v.shape[0] == b:
            # per-sample device-jitter factors: every camera of a sample
            # shares its factors (reference jitters per sample, not per cam)
            out[k] = np.repeat(v, n, axis=0)
        elif isinstance(v, np.ndarray) and v.ndim >= 3 and v.shape[:2] == (b, n):
            out[k] = fold(v)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray) \
                and v[0].ndim >= 3 and v[0].shape[:2] == (b, n):
            out[k] = [fold(x) for x in v]
        else:
            out[k] = v
    return out
