"""Checkpoints (port of ``packnet_sfm_tpu/engine/checkpoint.py``).

A checkpoint is a directory of two files:
- ``state.pt``: ``torch.save`` of {'model': the model's state_dict} and,
  where given, 'optimizer' and 'scheduler' state_dicts; read back with
  ``weights_only=True`` onto the CPU and copied into the caller's objects;
- ``meta.json``: the embedded config, epoch, monitored value and step, the
  JAX package's keys.
Top-k retention (``ModelCheckpoint``) and ImageNet encoder grafts come with
the trainer's ``fit`` (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def save_checkpoint(path: str, model: torch.nn.Module, config: Dict, epoch: int,
                    monitor_value: float = 0.0, step: int = 0,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None) -> str:
    """Write a checkpoint directory, replacing one already at ``path``."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {"model": model.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    torch.save(state, os.path.join(path, STATE_FILE))
    meta = {"config": config, "epoch": epoch, "monitor_value": monitor_value,
            "step": int(step)}
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def read_state(path: str) -> Dict:
    """The state dicts of a checkpoint directory, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, model: Optional[torch.nn.Module] = None,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       scheduler=None):
    """Load a checkpoint into the objects given (strictly) and return
    (state, meta): the state dicts as saved, and the meta dict."""
    path = os.path.abspath(path)
    state = read_state(path)
    for name, target in (("model", model), ("optimizer", optimizer),
                         ("scheduler", scheduler)):
        if target is None:
            continue
        if name not in state:
            raise KeyError(f"checkpoint {path} holds no {name} state")
        target.load_state_dict(state[name])
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    return state, meta


def load_network(path: str, model: torch.nn.Module, network: str) -> int:
    """Load one sub-network's tensors from a checkpoint into ``model``.

    Prefix-matched partial load (reference utils/load.py:114): of the
    checkpoint's entries under ``network`` ('depth_net' or 'pose_net'),
    those the model has with the same shape are copied, the others are
    skipped; prints and returns the count loaded.
    """
    prefix = network + "."
    saved = read_state(path)["model"]
    own = model.state_dict()
    n_total = sum(k.startswith(prefix) for k in own)
    matched = {k: v for k, v in saved.items()
               if k.startswith(prefix) and k in own and own[k].shape == v.shape}
    with torch.no_grad():
        for k, v in matched.items():
            own[k].copy_(v)
    print(f"### Loaded {len(matched)}/{n_total} tensors for {network} from {path}")
    return len(matched)
