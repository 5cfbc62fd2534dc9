"""SfM model family (port of ``packnet_sfm_tpu/models/sfm.py``).

``SfmModelDef`` holds the networks and the loss configuration;
``model_forward`` and ``model_loss`` run them on a batch of NHWC tensors.
This slice ports the ``GenericSelfSupModel`` kind (NRS self-supervised
training), which has no flip TTA; other kinds raise ``NotImplementedError``
until their slice lands (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from packnet_sfm_tpu_torch.geometry.camera_generic import (
    canonical_pinhole_rays,
    projection_temperature,
)
from packnet_sfm_tpu_torch.geometry.pose import pose_vec_to_mat
from packnet_sfm_tpu_torch.losses.generic_photometric import (
    GenericPhotometricConfig,
    generic_multiview_photometric_loss,
)

PORTED_KINDS = ("GenericSelfSupModel",)


class SfmModelDef(nn.Module):
    """Depth (+ pose) networks and the loss configuration of one model kind."""

    def __init__(self, depth_net: nn.Module, pose_net: Optional[nn.Module],
                 kind: str = "GenericSelfSupModel",
                 generic_photometric: Optional[GenericPhotometricConfig] = None,
                 rotation_mode: str = "euler"):
        super().__init__()
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"model kind {kind!r} is not ported yet; see ROADMAP.md")
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.kind = kind
        self.generic_photometric = generic_photometric or GenericPhotometricConfig()
        self.rotation_mode = rotation_mode


def model_forward(model: SfmModelDef, batch: Dict, train: bool = True) -> Dict:
    """Run the depth (+ pose) networks on a batch.

    batch keys (NHWC): 'rgb' [B,H,W,3]; optional 'rgb_context' list. Returns
    'inv_depths' (list, finest first), 'ray_surface' and 'poses' (list of
    [B,4,4] target->context transforms, or None). ``train`` sets the
    modules' mode: in training, BatchNorm moves its running statistics.
    """
    model.train(train)
    out = dict(model.depth_net(batch["rgb"]))
    out["poses"] = None
    if "rgb_context" in batch and model.pose_net is not None:
        pose_vec = model.pose_net(batch["rgb"], batch["rgb_context"])
        out["poses"] = [pose_vec_to_mat(pose_vec[:, i], model.rotation_mode)
                        for i in range(pose_vec.shape[1])]
    return out


def model_loss(model: SfmModelDef, batch: Dict, progress: float = 0.0):
    """Training loss for the model's kind: (loss, (metrics, output)).

    ``progress`` is the Python float fraction of training done; the
    projection temperature and the ray-surface blend are computed from it
    on the host.
    """
    if isinstance(progress, torch.Tensor):
        raise TypeError("progress must be a Python float")
    out = model_forward(model, batch, train=True)
    image = batch.get("rgb_original", batch["rgb"])
    h, w = image.shape[1:3]
    loss, metrics = generic_multiview_photometric_loss(
        image,
        batch.get("rgb_context_original", batch.get("rgb_context")),
        out["inv_depths"],
        out["ray_surface"],
        canonical_pinhole_rays(h, w, device=image.device),
        out["poses"],
        model.generic_photometric,
        float(progress),
        projection_temperature(progress),
    )
    metrics["loss"] = loss
    return loss, (metrics, out)
