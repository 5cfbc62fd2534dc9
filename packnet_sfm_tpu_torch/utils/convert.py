"""Carry weights from the JAX package's variables to the port.

``from_jax(params, batch_stats)`` takes the JAX variables as nested dicts of
numpy arrays (``init_model``'s 'params' and 'batch_stats' collections, e.g.
{'depth_net': ..., 'pose_net': ...}) and returns a state_dict for
``SfmModelDef.load_state_dict``. The port's submodules are named after the
flax module tree, so the mapping is by name:

- 2D conv ``kernel`` [kh, kw, in, out] -> ``weight`` [out, in, kh, kw];
- PackNet's 3D conv ``kernel`` [kz, kh, kw, 1, d] -> ``weight``
  [d, 1, kz, kh, kw] (the pack layer's fused block keeps the flax tree of the
  unfused one, ``Conv_0`` + ``Conv2dBlock_0/Conv_0``, so it maps the same way);
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var`` (flax's inner ``BatchNorm_0`` level goes);
- GroupNorm ``scale``/``bias`` -> ``weight``/``bias``;
- the sparse branch's MaskedBatchNorm ``scale``/``bias``/``mean``/``var``
  (no inner level) -> ``weight``/``bias``/``running_mean``/``running_var``;
- PackNet-SAN's level vectors ``weight``/``bias`` [5] keep their names;
- flax auto-names ``Conv_0``/``GroupNorm_0`` -> ``conv``/``norm``.

The ResNet family's Bottleneck blocks and PoseResNet's two-image conv1
(kernel [7, 7, 6, 64]) map by the same rules.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

_RENAME = {"Conv_0": "conv", "GroupNorm_0": "norm"}
# flax kernel axes -> PyTorch weight axes, by kernel rank.
_KERNEL_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_LEAF = {"kernel": "weight", "scale": "weight", "weight": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path) -> str:
    *mods, leaf = path
    mods = [_RENAME.get(m, m) for m in mods if m != "BatchNorm_0"]
    return ".".join(mods + [_LEAF[leaf]])


def from_jax(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    state = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            arr = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                if arr.ndim not in _KERNEL_AXES:
                    raise ValueError(f"{'/'.join(path)}: no rule for a {arr.ndim}-D kernel")
                arr = arr.transpose(_KERNEL_AXES[arr.ndim])
            state[_torch_key(path)] = torch.tensor(arr)
    return state
