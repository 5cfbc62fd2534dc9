"""Host side of the training augmentations: the port's own copy of
``draw_jitter_params`` from ``packnet_sfm_tpu/datasets/augmentations.py``
(numpy only; same factors for the same generator state). The jitter itself
runs on the device (``ops/jitter.apply_jitter``).
"""

from __future__ import annotations

import numpy as np


def draw_jitter_params(parameters, rng: np.random.Generator,
                       prob: float = 1.0) -> np.ndarray:
    """Draw one sample's shared jitter factors [b, c, s, hue] (identity =
    [1, 1, 1, 0]): brightness/contrast/saturation in [max(0, 1-v), 1+v],
    hue in [-v, v]."""
    if rng.uniform() > prob:
        return np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    bv, cv, sv, hv = parameters
    return np.array([
        rng.uniform(max(0.0, 1 - bv), 1 + bv),
        rng.uniform(max(0.0, 1 - cv), 1 + cv),
        rng.uniform(max(0.0, 1 - sv), 1 + sv),
        rng.uniform(-hv, hv),
    ], np.float32)
