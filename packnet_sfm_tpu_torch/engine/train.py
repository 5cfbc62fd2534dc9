"""Train step (port of ``packnet_sfm_tpu/engine/train.py``).

``make_train_step`` returns a step doing forward, backward, the Adam update,
the learning-rate schedule and the BatchNorm running-statistics update, and
adding the step's metrics to a device-side accumulator {key: [sum, count]}
that the caller reads once per epoch. Float32 only; the bfloat16 policy of
``arch.dtype`` comes in a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from packnet_sfm_tpu_torch.models.sfm import SfmModelDef, model_loss
from packnet_sfm_tpu_torch.ops.jitter import apply_jitter

METRIC_KEYS = ("loss", "photometric_loss", "smoothness_loss",
               "supervised_loss", "supervised_loss_rgbd", "depth_loss",
               "velocity_loss")


def zero_metrics(device) -> Dict[str, torch.Tensor]:
    """Device-side metric accumulator: {key: [sum, count]}."""
    return {k: torch.zeros(2, dtype=torch.float32, device=device) for k in METRIC_KEYS}


def prepare_train_batch(batch: Dict, device) -> Dict:
    """Device half of the input pipeline: move a host batch (numpy, NHWC) to
    ``device``, decode uint8 and apply the device jitter.

    uint8 images are scaled to [0, 1] in float32. With a 'jitter' key
    ([B, 4] factors, ``ops/jitter.apply_jitter``) the networks see the
    jittered 'rgb' and 'rgb_context' while 'rgb_original' and
    'rgb_context_original' keep the plain images for the loss; without it
    the originals alias the images. 'intrinsics' goes along as float32.
    """
    def to_f(x):
        t = torch.as_tensor(np.asarray(x)).to(device, non_blocking=True)
        return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()

    rgb = to_f(batch["rgb"])
    ctx = [to_f(c) for c in batch.get("rgb_context", [])]
    out = {"rgb": rgb, "rgb_original": rgb}
    if ctx:
        out["rgb_context"] = out["rgb_context_original"] = ctx
    if batch.get("jitter") is not None:
        params = to_f(batch["jitter"])
        out["rgb"] = apply_jitter(rgb, params)
        if ctx:
            out["rgb_context"] = [apply_jitter(c, params) for c in ctx]
    if "intrinsics" in batch:
        out["intrinsics"] = to_f(batch["intrinsics"])
    return out


def _microbatches(batch: Dict, grad_accum: int):
    """Split every leaf of a prepared batch into ``grad_accum`` equal parts
    along the batch axis."""
    b = batch["rgb"].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} does not split into {grad_accum} microbatches")
    m = b // grad_accum
    for g in range(grad_accum):
        part = slice(g * m, (g + 1) * m)
        yield {k: [t[part] for t in v] if isinstance(v, list) else v[part]
               for k, v in batch.items()}


def make_train_step(model: SfmModelDef, optimizer: torch.optim.Optimizer, scheduler=None,
                    num_scales: Optional[int] = None, grad_accum: int = 1,
                    generator: Optional[torch.Generator] = None):
    """Returns step(acc, batch, progress) -> acc, in float32.

    ``batch`` is a host batch (see ``prepare_train_batch``); ``progress``
    is the Python float fraction of training done. ``num_scales`` overrides
    the photometric scale count. ``grad_accum`` > 1 splits the batch into
    microbatches whose gradients and metrics are averaged before the one
    optimizer step. ``generator`` (a CPU ``torch.Generator``) draws the
    training flip of ``SelfSupModel``; without it there is no flip.
    """
    device = next(model.parameters()).device

    def step(acc: Dict[str, torch.Tensor], batch: Dict, progress: float = 0.0):
        batch = prepare_train_batch(batch, device)
        optimizer.zero_grad(set_to_none=True)
        totals: Dict[str, torch.Tensor] = {}
        parts = [batch] if grad_accum <= 1 else _microbatches(batch, grad_accum)
        for part in parts:
            loss, (metrics, _) = model_loss(model, part, progress=progress,
                                            num_scales=num_scales, generator=generator)
            (loss / max(grad_accum, 1)).backward()
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v.detach().float() / max(grad_accum, 1)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        with torch.no_grad():
            for k in METRIC_KEYS:
                if k in totals:
                    acc[k] += torch.stack([totals[k], torch.ones((), device=device)])
        return acc

    return step
