"""SfM model family (port of ``packnet_sfm_tpu/models/sfm.py``).

``SfmModelDef`` holds the networks and the loss configuration;
``model_forward`` and ``model_loss`` run them on a batch of NHWC tensors,
under the profiler ranges ``depth_net``, ``pose_net`` and
``photometric_loss`` that ``tools/profile_step.py`` reads.
Ported kinds: ``SelfSupModel`` (pinhole photometric loss, with the random
left-right flip of the depth network's input during training) and
``GenericSelfSupModel`` (NRS self-supervised training, no flip); other kinds
raise ``NotImplementedError`` until their slice lands (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.profiler import record_function

from packnet_sfm_tpu_torch.geometry.camera_generic import (
    canonical_pinhole_rays,
    projection_temperature,
)
from packnet_sfm_tpu_torch.geometry.pose import pose_vec_to_mat
from packnet_sfm_tpu_torch.losses.generic_photometric import (
    GenericPhotometricConfig,
    generic_multiview_photometric_loss,
)
from packnet_sfm_tpu_torch.losses.photometric import (
    MultiViewPhotometricConfig,
    multiview_photometric_loss,
)
from packnet_sfm_tpu_torch.ops.image import flip_lr, interpolate_image

PORTED_KINDS = ("SelfSupModel", "GenericSelfSupModel")


class SfmModelDef(nn.Module):
    """Depth (+ pose) networks and the loss configuration of one model kind."""

    def __init__(self, depth_net: nn.Module, pose_net: Optional[nn.Module],
                 kind: str = "SelfSupModel",
                 photometric: Optional[MultiViewPhotometricConfig] = None,
                 generic_photometric: Optional[GenericPhotometricConfig] = None,
                 rotation_mode: str = "euler", flip_lr_prob: float = 0.5,
                 upsample_depth_maps: bool = False):
        super().__init__()
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"model kind {kind!r} is not ported yet; see ROADMAP.md")
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.kind = kind
        self.photometric = photometric or MultiViewPhotometricConfig()
        self.generic_photometric = generic_photometric or GenericPhotometricConfig()
        self.rotation_mode = rotation_mode
        # the generic (NRS) kinds have no flip
        self.flip_lr_prob = 0.0 if kind.startswith("Generic") else flip_lr_prob
        self.upsample_depth_maps = upsample_depth_maps


def _normalize_depth_output(out) -> Dict:
    """Depth nets return either a scale list or a dict."""
    return dict(out) if isinstance(out, dict) else {"inv_depths": list(out)}


def _depth_with_flip(model: SfmModelDef, batch: Dict, generator, train: bool) -> Dict:
    """Depth forward with the random left-right flip of training.

    The flip is drawn on the host from ``generator`` (a CPU
    ``torch.Generator``), so it is a Python bool: eager PyTorch needs no
    traced select, the network simply runs on the flipped image and its
    outputs are flipped back. No generator, no flip.
    """
    rgb = batch["rgb"]
    do_flip = False
    if train and model.flip_lr_prob > 0.0 and generator is not None:
        do_flip = torch.rand((), generator=generator).item() < model.flip_lr_prob
    with record_function("depth_net"):
        out = _normalize_depth_output(model.depth_net(flip_lr(rgb) if do_flip else rgb))
    if do_flip:
        out["inv_depths"] = [flip_lr(d) for d in out["inv_depths"]]
    if train and model.upsample_depth_maps:
        full = out["inv_depths"][0].shape[1:3]
        out["inv_depths"] = [interpolate_image(d, full, mode="nearest")
                             for d in out["inv_depths"]]
    return out


def model_forward(model: SfmModelDef, batch: Dict, train: bool = True,
                  generator: Optional[torch.Generator] = None) -> Dict:
    """Run the depth (+ pose) networks on a batch.

    batch keys (NHWC): 'rgb' [B,H,W,3]; optional 'rgb_context' list. Returns
    'inv_depths' (list, finest first), 'ray_surface' for the NRS network, and
    'poses' (list of [B,4,4] target->context transforms, or None). ``train``
    sets the modules' mode: in training, BatchNorm moves its running
    statistics. ``generator`` draws the training flip (see
    ``_depth_with_flip``).
    """
    model.train(train)
    out = _depth_with_flip(model, batch, generator, train)
    out["poses"] = None
    if "rgb_context" in batch and model.pose_net is not None:
        with record_function("pose_net"):
            pose_vec = model.pose_net(batch["rgb"], batch["rgb_context"])
        out["poses"] = [pose_vec_to_mat(pose_vec[:, i], model.rotation_mode)
                        for i in range(pose_vec.shape[1])]
    return out


def model_loss(model: SfmModelDef, batch: Dict, progress: float = 0.0,
               num_scales: Optional[int] = None,
               generator: Optional[torch.Generator] = None):
    """Training loss for the model's kind: (loss, (metrics, output)).

    ``progress`` is the Python float fraction of training done; the NRS
    projection temperature and ray-surface blend are computed from it on the
    host. ``num_scales`` overrides the photometric scale count (the trainer
    resolves the progressive schedule, ``losses/progressive.py``).
    """
    if isinstance(progress, torch.Tensor):
        raise TypeError("progress must be a Python float")
    out = model_forward(model, batch, train=True, generator=generator)
    image = batch.get("rgb_original", batch["rgb"])
    context = batch.get("rgb_context_original", batch.get("rgb_context"))
    if model.kind == "GenericSelfSupModel":
        h, w = image.shape[1:3]
        with record_function("photometric_loss"):
            loss, metrics = generic_multiview_photometric_loss(
                image, context, out["inv_depths"], out["ray_surface"],
                canonical_pinhole_rays(h, w, device=image.device), out["poses"],
                model.generic_photometric, float(progress),
                projection_temperature(progress))
    else:
        photo_cfg = model.photometric
        if num_scales is not None and num_scales != photo_cfg.num_scales:
            photo_cfg = dataclasses.replace(photo_cfg, num_scales=num_scales)
        with record_function("photometric_loss"):
            loss, metrics = multiview_photometric_loss(
                image, context, out["inv_depths"], batch["intrinsics"], out["poses"],
                photo_cfg)
    metrics["loss"] = loss
    return loss, (metrics, out)
