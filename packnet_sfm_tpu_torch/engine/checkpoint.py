"""Checkpoints (port of ``packnet_sfm_tpu/engine/checkpoint.py``).

A checkpoint is a directory of two files:
- ``state.pt``: ``torch.save`` of {'model': the model's state_dict} and,
  where given, the 'optimizer' and 'scheduler' state_dicts and the
  'generator' state of the training flip's CPU ``torch.Generator``, which
  with the step is what an exact resume needs (the JAX package restores its
  ``step`` and ``rng`` the same way); read back with ``weights_only=True``
  onto the CPU and copied into the caller's objects;
- ``meta.json``: the embedded config, epoch, monitored value and step, the
  JAX package's keys.
``ModelCheckpoint`` keeps the top k of them by a monitored metric;
``load_network`` and ``load_pretrained_encoder`` are the init-time partial
loads.

With more than one process, every process calls ``save_checkpoint`` and
``ModelCheckpoint.check_and_save`` at the same point: rank 0 writes (and
deletes a checkpoint pushed out of the top k) between two barriers, and
every rank takes rank 0's monitored value, so that all of them make its
decision and name its path. Reading (``restore_checkpoint``,
``load_network``) runs on every rank.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterable, Optional

import torch

from packnet_sfm_tpu_torch.parallel.mesh import barrier, broadcast_object, process_index

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _mode_for(monitor: str, mode: str) -> str:
    if mode != "auto":
        return mode
    return "max" if ("a1" in monitor or "acc" in monitor) else "min"


class ModelCheckpoint:
    """Top-k checkpoint manager keyed on a monitored metric: a checkpoint
    is written when its value ranks among the best ``save_top_k`` so far
    (lower is better, or higher for ``mode: max``; ``auto`` takes max for
    'a1'/'acc' metrics), and the one it pushes out is deleted. Names are
    ``epoch=NN_<monitor>=V.ckpt`` with '/' in the monitor replaced by '-'.

    The monitor must be one of the metrics handed to ``check_and_save``:
    an unknown one raises ``KeyError`` (the JAX package ranks by the loss
    instead, silently). Syncing to S3 (the ``aws`` CLI) is not ported.
    """

    def __init__(self, dirpath: str, monitor: str = "loss", save_top_k: int = 5,
                 mode: str = "auto", s3_path: str = "", s3_frequency: int = 1):
        if s3_path:
            raise NotImplementedError(
                "checkpoint.s3_path: syncing checkpoints to S3 (the aws CLI and the network) "
                "is not ported")
        self.dirpath = os.path.abspath(dirpath)
        os.makedirs(self.dirpath, exist_ok=True)
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.mode = _mode_for(monitor, mode)
        self._saved: list[tuple[float, str]] = []

    def check_monitor(self, keys: Iterable[str]) -> None:
        """Raise ``KeyError`` unless the monitor is among ``keys``."""
        keys = sorted(keys)
        if self.monitor not in keys:
            raise KeyError(f"checkpoint.monitor {self.monitor!r} is not a metric of this run; "
                           f"the metrics are: {', '.join(keys)}")

    def _is_better(self, value: float, worst: float) -> bool:
        return value > worst if self.mode == "max" else value < worst

    def check_and_save(self, model: torch.nn.Module, config: Dict, epoch: int,
                       metrics: Dict[str, float], **train_state) -> Optional[str]:
        """Save if within the top k by the monitored metric; returns the
        path or None. ``train_state`` goes to ``save_checkpoint`` (step,
        optimizer, scheduler, generator). Every rank takes rank 0's value."""
        self.check_monitor(metrics)
        value = broadcast_object(float(metrics[self.monitor]))
        if self.save_top_k > 0 and len(self._saved) >= self.save_top_k:
            worst = self._saved[-1][0]
            if not self._is_better(value, worst):
                return None
        name = f"epoch={epoch:02d}_{self.monitor.replace('/', '-')}={value:.3f}.ckpt"
        path = os.path.join(self.dirpath, name)
        save_checkpoint(path, model, config, epoch, value, **train_state)
        self._saved.append((value, path))
        self._saved.sort(key=lambda kv: kv[0], reverse=(self.mode == "max"))
        while self.save_top_k > 0 and len(self._saved) > self.save_top_k:
            _, old = self._saved.pop()
            if process_index() == 0:
                shutil.rmtree(old, ignore_errors=True)
        return path


def save_checkpoint(path: str, model: torch.nn.Module, config: Dict, epoch: int,
                    monitor_value: float = 0.0, step: int = 0,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None, generator: Optional[torch.Generator] = None) -> str:
    """Write a checkpoint directory, replacing one already at ``path``: on
    rank 0, while every rank waits at a barrier before and after it."""
    path = os.path.abspath(path)
    barrier()
    if process_index() == 0:
        _write_checkpoint(path, model, config, epoch, monitor_value, step, optimizer,
                          scheduler, generator)
    barrier()
    return path


def _write_checkpoint(path, model, config, epoch, monitor_value, step, optimizer, scheduler,
                      generator):
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {"model": model.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    if generator is not None:
        state["generator"] = generator.get_state()
    torch.save(state, os.path.join(path, STATE_FILE))
    meta = {"config": config, "epoch": epoch, "monitor_value": monitor_value,
            "step": int(step)}
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=str)


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


def load_pretrained_encoder(artifact_path: str, model: torch.nn.Module, network: str,
                            num_input_images: int = 1) -> int:
    """Graft ImageNet-pretrained ResNet encoder weights into ``model``.

    The artifact is an npz of the encoder's flax tree (``utils/
    torch_import.load_encoder_artifact``), mapped by ``utils/convert.
    from_jax`` onto ``<network>.encoder.``; ``num_input_images`` > 1 widens
    conv1 for stacked frames. A key the model lacks raises ``KeyError``, a
    shape that differs ``ValueError``. Returns the count loaded.
    """
    from packnet_sfm_tpu_torch.utils.convert import from_jax
    from packnet_sfm_tpu_torch.utils.torch_import import (
        adapt_conv1_multiimage,
        load_encoder_artifact,
    )

    enc_params, enc_stats = load_encoder_artifact(artifact_path)
    if num_input_images > 1 and "conv1" in enc_params:
        enc_params["conv1"]["kernel"] = adapt_conv1_multiimage(
            enc_params["conv1"]["kernel"], num_input_images)
    grafted = from_jax({network: {"encoder": enc_params}},
                       {network: {"encoder": enc_stats}} if enc_stats else None)
    own = model.state_dict()
    for key, value in grafted.items():
        if key not in own:
            raise KeyError(f"pretrained artifact key {key} not in model")
        if own[key].shape != value.shape:
            raise ValueError(f"pretrained shape mismatch at {key}: {tuple(value.shape)} vs "
                             f"model {tuple(own[key].shape)}")
    with torch.no_grad():
        for key, value in grafted.items():
            own[key].copy_(value)
    print(f"### Loaded {len(grafted)} pretrained encoder tensors for {network} "
          f"from {artifact_path}")
    return len(grafted)
