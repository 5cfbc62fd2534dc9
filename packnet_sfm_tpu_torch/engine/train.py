"""Train step (port of ``packnet_sfm_tpu/engine/train.py``).

``make_train_step`` returns a step doing forward, backward, the Adam update,
the learning-rate schedule and the BatchNorm running-statistics update, and
adding the step's metrics to a device-side accumulator {key: [sum, count]}
that the caller reads once per epoch. This slice runs float32 only; the
bfloat16 policy of ``arch.dtype`` comes in a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from packnet_sfm_tpu_torch.models.sfm import SfmModelDef, model_loss

METRIC_KEYS = ("loss", "photometric_loss", "smoothness_loss",
               "supervised_loss", "supervised_loss_rgbd", "depth_loss",
               "velocity_loss")


def zero_metrics(device) -> Dict[str, torch.Tensor]:
    """Device-side metric accumulator: {key: [sum, count]}."""
    return {k: torch.zeros(2, dtype=torch.float32, device=device) for k in METRIC_KEYS}


def prepare_train_batch(batch: Dict, device) -> Dict:
    """Move a host batch's images (numpy NHWC) to ``device`` as float32.

    uint8 images are scaled to [0, 1]; 'rgb_original' and
    'rgb_context_original' alias the images. Device jitter (a 'jitter' key)
    is not ported yet.
    """
    if "jitter" in batch:
        raise NotImplementedError("device jitter is not ported yet; see ROADMAP.md")

    def to_f(x):
        t = torch.as_tensor(np.asarray(x)).to(device, non_blocking=True)
        return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()

    out = {"rgb": to_f(batch["rgb"])}
    out["rgb_original"] = out["rgb"]
    if "rgb_context" in batch:
        out["rgb_context"] = [to_f(c) for c in batch["rgb_context"]]
        out["rgb_context_original"] = out["rgb_context"]
    return out


def make_train_step(model: SfmModelDef, optimizer: torch.optim.Optimizer, scheduler=None):
    """Returns step(acc, batch, progress) -> acc, in float32.

    ``batch`` is a host batch (see ``prepare_train_batch``); ``progress``
    is the Python float fraction of training done.
    """
    device = next(model.parameters()).device

    def step(acc: Dict[str, torch.Tensor], batch: Dict, progress: float = 0.0):
        batch = prepare_train_batch(batch, device)
        optimizer.zero_grad(set_to_none=True)
        loss, (metrics, _) = model_loss(model, batch, progress=progress)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        with torch.no_grad():
            for k in METRIC_KEYS:
                if k in metrics:
                    acc[k] += torch.stack([metrics[k].detach().float(),
                                           torch.ones((), device=device)])
        return acc

    return step
