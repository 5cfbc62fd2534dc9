"""Encoder weight artifacts: the port's own copy of the part of
``packnet_sfm_tpu/utils/torch_import.py`` that the ImageNet encoder graft
needs (numpy only): the npz artifact's layout, its reader and the conv1
widening for stacked frames. The artifact holds the encoder's flax tree
('params/<path>' and 'stats/<path>' keys), as the JAX package's
``save_encoder_artifact`` writes it; ``engine/checkpoint.
load_pretrained_encoder`` maps it onto the port's modules. The reference
checkpoint converters come with ROADMAP.md §1 item 10.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def adapt_conv1_multiimage(kernel: np.ndarray, num_input_images: int) -> np.ndarray:
    """Widen a flax conv1 kernel [kh, kw, 3, 64] for stacked-frame input:
    tiled across the input-channel axis and divided by the image count, so
    that activations keep their scale."""
    if num_input_images <= 1:
        return kernel
    return np.concatenate([kernel] * num_input_images, axis=2) / num_input_images


def _flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_encoder_artifact(path: str) -> Tuple[Dict, Dict]:
    """Read an encoder-weights npz artifact -> (params, batch_stats)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten_tree(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten_tree(
        {k[len("stats/"):]: v for k, v in flat.items() if k.startswith("stats/")})
    return params, stats
