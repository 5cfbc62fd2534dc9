"""SfM model family (port of ``packnet_sfm_tpu/models/sfm.py``).

``SfmModelDef`` holds the networks and the loss configuration;
``model_forward`` and ``model_loss`` run them on a batch of NHWC tensors,
under the spans ``depth_net``, ``pose_net``, ``photometric_loss`` and
``supervised_loss`` (``engine/spans.py``: profiler ranges, and host times
while recording). The kinds (``MODEL_KINDS``), as the JAX package defines
them:

- ``SfmModel``: the networks only; its loss is 0 (no term);
- ``SelfSupModel``: the pinhole photometric loss;
- ``SemiSupModel``: (1 - w) * self-supervised + w * supervised, w =
  ``supervised_loss_weight``; at w >= 1 the photometric graph is skipped
  (and ``engine/factory`` builds no pose net);
- ``SemiSupCompletionModel``: SemiSup on a depth network that also takes
  ``input_depth`` (PackNet-SAN): the rgb+d branch's supervised term,
  weighted by ``weight_rgbd * w``, and the network's ``depth_loss``;
- ``VelSupModel``: self-supervised + ``velocity_loss_weight`` * the
  velocity loss against the ground-truth ``pose_context``;
- ``GenericSfmModel`` / ``GenericSelfSupModel``: the NRS networks, with no
  loss / the generic photometric loss, and no flip.

During training the depth network's inputs (every image-like key of
``input_keys``: 'rgb', and 'input_depth' for completion) are flipped left
to right together at random, and its inverse depths flipped back.

On a band of rows (``band``, ``parallel/spatial.py``; ``check_band``: the
self-supervised, SemiSup, VelSup and NRS kinds, with PackNet, DepthResNet or
RaySurfaceResNet) the batch is whole: the depth network runs on the band's
rows of the image, the pose network on the whole images (every rank of the
space group computes the same poses), and the loss is the band's share. The
pose's gradient is still the whole batch's: each rank's share of the loss
reaches the pose only through its own rows, and the shares' gradients are
summed over the ranks. The velocity loss, a function of the poses alone, is
whole on every rank, and its share is the loss over the band count. The
supervised loss takes its sums over every rank's pixels
(``losses/supervised.py``), with a band or without one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from packnet_sfm_tpu_torch.engine import spans
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
from packnet_sfm_tpu_torch.losses.supervised import SupervisedLossConfig, supervised_loss
from packnet_sfm_tpu_torch.losses.velocity import velocity_loss
from packnet_sfm_tpu_torch.ops.image import flip_lr, interpolate_image
from packnet_sfm_tpu_torch.parallel import spatial
from packnet_sfm_tpu_torch.parallel.mesh import batch_group

MODEL_KINDS = ("SfmModel", "SelfSupModel", "SemiSupModel", "VelSupModel",
               "SemiSupCompletionModel", "GenericSfmModel", "GenericSelfSupModel")
SELF_SUP_KINDS = ("SelfSupModel", "SemiSupModel", "VelSupModel", "SemiSupCompletionModel")
SUPERVISED_KINDS = ("SemiSupModel", "SemiSupCompletionModel")
# inverse depths that every depth network returns, finest first
DEPTH_SCALES = 4


class SfmModelDef(nn.Module):
    """Depth (+ pose) networks and the loss configuration of one model kind."""

    def __init__(self, depth_net: nn.Module, pose_net: Optional[nn.Module],
                 kind: str = "SelfSupModel",
                 photometric: Optional[MultiViewPhotometricConfig] = None,
                 generic_photometric: Optional[GenericPhotometricConfig] = None,
                 supervised: Optional[SupervisedLossConfig] = None,
                 supervised_loss_weight: float = 0.9, velocity_loss_weight: float = 0.1,
                 weight_rgbd: float = 1.0, rotation_mode: str = "euler",
                 flip_lr_prob: float = 0.5, upsample_depth_maps: bool = False,
                 input_keys: tuple = ("rgb",)):
        super().__init__()
        if kind not in MODEL_KINDS:
            raise ValueError(f"Unknown model {kind}")
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.kind = kind
        self.photometric = photometric or MultiViewPhotometricConfig()
        self.generic_photometric = generic_photometric or GenericPhotometricConfig()
        self.supervised = supervised or SupervisedLossConfig()
        self.supervised_loss_weight = supervised_loss_weight
        self.velocity_loss_weight = velocity_loss_weight
        self.weight_rgbd = weight_rgbd
        self.rotation_mode = rotation_mode
        # the generic (NRS) kinds have no flip
        self.flip_lr_prob = 0.0 if kind.startswith("Generic") else flip_lr_prob
        self.upsample_depth_maps = upsample_depth_maps
        self.input_keys = tuple(input_keys)
        self._canonical_rays: Dict = {}

    def canonical_rays(self, h: int, w: int, device) -> torch.Tensor:
        """``canonical_pinhole_rays(h, w)`` on ``device``, built and copied
        there once per (h, w, device) and kept: an NRS step reads the same
        bits every step with no copy from pageable host memory, which would
        wait for the device's stream. The one copy is counted in the record
        of the step that makes it (``engine/spans.note_copy``). Read only."""
        key = (h, w, torch.device(device))
        if key not in self._canonical_rays:
            host = canonical_pinhole_rays(h, w, device="cpu")
            spans.note_copy(host)
            self._canonical_rays[key] = host.to(key[2])
        return self._canonical_rays[key]

    @property
    def has_loss(self) -> bool:
        """Whether ``model_loss`` has a term to train: every kind but
        ``SfmModel`` and ``GenericSfmModel``."""
        return self.kind not in ("SfmModel", "GenericSfmModel")

    @property
    def photometric_used(self) -> bool:
        """Whether ``model_loss`` runs the photometric graph: the
        self-supervised kinds, except a supervised kind at weight >= 1."""
        if self.kind not in SELF_SUP_KINDS:
            return False
        return not (self.kind in SUPERVISED_KINDS and self.supervised_loss_weight >= 1.0)


def _normalize_depth_output(out) -> Dict:
    """Depth nets return either a scale list or a dict."""
    return dict(out) if isinstance(out, dict) else {"inv_depths": list(out)}


def _depth_with_flip(model: SfmModelDef, batch: Dict, generator, train: bool,
                     band: Optional[spatial.Band] = None) -> Dict:
    """Depth forward with the random left-right flip of training.

    The flip is drawn on the host from ``generator`` (a CPU
    ``torch.Generator``), so it is a Python bool: eager PyTorch needs no
    traced select, the network simply runs on the flipped inputs (every one
    of them: rgb and input_depth alike) and its inverse depths are flipped
    back. No generator, no flip. On a ``band`` the network runs on the
    band's rows (the flip is along W, within them).
    """
    inputs = {k: batch[k] for k in model.input_keys if k != "intrinsics" and k in batch}
    if band is not None:
        inputs = {k: band.take(v) for k, v in inputs.items()}
    do_flip = False
    if train and model.flip_lr_prob > 0.0 and generator is not None:
        do_flip = torch.rand((), generator=generator).item() < model.flip_lr_prob
    if do_flip:
        inputs = {k: flip_lr(v) for k, v in inputs.items()}
    rgb = inputs.pop("rgb")
    with spans.span("depth_net"), spatial.use(band):
        out = _normalize_depth_output(model.depth_net(rgb, **inputs))
    if do_flip:
        for key in ("inv_depths", "inv_depths_rgbd"):
            if key in out:
                out[key] = [flip_lr(d) for d in out[key]]
    if train and model.upsample_depth_maps:
        h, w = out["inv_depths"][0].shape[1:3]
        full = (h if band is None else band.rows(h), w)
        out["inv_depths"] = [interpolate_image(d, full, mode="nearest", band=band)
                             for d in out["inv_depths"]]
    return out


def model_forward(model: SfmModelDef, batch: Dict, train: bool = True,
                  generator: Optional[torch.Generator] = None,
                  band: Optional[spatial.Band] = None) -> Dict:
    """Run the depth (+ pose) networks on a batch.

    batch keys (NHWC): 'rgb' [B,H,W,3]; optional 'input_depth' [B,H,W,1]
    (where ``input_keys`` names it) and 'rgb_context' list. Returns
    'inv_depths' (list, finest first), 'ray_surface' for the NRS network,
    'inv_depths_rgbd' and 'depth_loss' for PackNet-SAN's training passes,
    and 'poses' (list of [B,4,4] target->context transforms, or None). ``train``
    sets the modules' mode: in training, BatchNorm moves its running
    statistics. ``generator`` draws the training flip (see
    ``_depth_with_flip``). On a ``band`` the inverse depths are the band's
    rows (see the module docstring).
    """
    model.train(train)
    out = _depth_with_flip(model, batch, generator, train, band)
    out["poses"] = None
    if "rgb_context" in batch and model.pose_net is not None:
        with spans.span("pose_net"):
            pose_vec = model.pose_net(batch["rgb"], batch["rgb_context"])
        out["poses"] = [pose_vec_to_mat(pose_vec[:, i], model.rotation_mode)
                        for i in range(pose_vec.shape[1])]
    return out


def depth2inv(depth: torch.Tensor) -> torch.Tensor:
    """Depth -> inverse depth, 0 where the depth is not positive."""
    inv = 1.0 / torch.clamp(depth, min=1e-6)
    return torch.where(depth <= 0.0, torch.zeros_like(inv), inv)


def scales_used(model: SfmModelDef, num_scales: Optional[int] = None) -> int:
    """How many of the depth network's inverse depths ``model_loss`` reads:
    the generic loss's scale count for NRS; else the largest of the
    photometric scale count (``num_scales`` or the config's), where the
    photometric graph runs, and the supervised one, where a supervised
    term runs. 0 for the kinds without a loss."""
    if model.kind == "GenericSelfSupModel":
        return model.generic_photometric.num_scales
    used = 0
    if model.photometric_used:
        used = num_scales or model.photometric.num_scales
    if model.kind in SUPERVISED_KINDS:
        used = max(used, model.supervised.supervised_num_scales)
    return used


# the kinds that train on a band; the others have no loss (SfmModel,
# GenericSfmModel, refused in a process group already) or no JAX path to
# port (SemiSupCompletionModel)
BAND_KINDS = ("SelfSupModel", "SemiSupModel", "VelSupModel", "GenericSelfSupModel")


def check_band(model: SfmModelDef, height: Optional[int], band: spatial.Band) -> None:
    """Refuse what cannot run on ``band``: a kind without a band path, a
    depth network without a ``space_stride``, or an image height (None: not
    known yet) that does not split into bands of a multiple of it."""
    if model.kind == "SemiSupCompletionModel":
        raise ValueError(
            "SemiSupCompletionModel does not run on a space axis: the JAX package cannot "
            "train it to port its grid step (ROADMAP.md section 3, faults (m) its bfloat16 "
            "step, (n) its sparse pool's gradient, (o) its dropout)")
    if model.kind not in BAND_KINDS:
        raise ValueError(f"{model.kind} does not run on a space axis: "
                         f"{', '.join(BAND_KINDS)} do")
    stride = spatial.network_stride(model.depth_net)
    if height is not None:
        spatial.check_rows(height, band.count, stride)


def model_loss(model: SfmModelDef, batch: Dict, progress: float = 0.0,
               num_scales: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               band: Optional[spatial.Band] = None):
    """Training loss for the model's kind: (loss, (metrics, output)).

    ``progress`` is the Python float fraction of training done; the NRS
    projection temperature and ray-surface blend are computed from it on the
    host. ``num_scales`` overrides the photometric scale count (the trainer
    resolves the progressive schedule, ``losses/progressive.py``). The
    kinds without a loss (``SfmModel``, ``GenericSfmModel``) return a 0
    that needs no gradient. On a ``band`` (``check_band``) the loss and the
    metrics are the band's shares.
    """
    if isinstance(progress, torch.Tensor):
        raise TypeError("progress must be a Python float")
    if band is not None:
        check_band(model, batch["rgb"].shape[1], band)
    out = model_forward(model, batch, train=True, generator=generator, band=band)
    image = batch.get("rgb_original", batch["rgb"])
    context = batch.get("rgb_context_original", batch.get("rgb_context"))
    if model.kind == "GenericSelfSupModel":
        h, w = image.shape[1:3]
        canonical = model.canonical_rays(h, w, image.device)
        with spans.span("photometric_loss"):
            loss, metrics = generic_multiview_photometric_loss(
                image, context, out["inv_depths"], out["ray_surface"],
                canonical if band is None else band.take(canonical, dim=0), out["poses"],
                model.generic_photometric, float(progress),
                projection_temperature(progress), band=band)
        metrics["loss"] = loss
        return loss, (metrics, out)

    metrics: Dict = {}
    loss = torch.zeros((), device=image.device)
    supervised = model.kind in SUPERVISED_KINDS
    w = model.supervised_loss_weight
    if model.photometric_used:
        photo_cfg = model.photometric
        if num_scales is not None and num_scales != photo_cfg.num_scales:
            photo_cfg = dataclasses.replace(photo_cfg, num_scales=num_scales)
        with spans.span("photometric_loss"):
            self_loss, self_metrics = multiview_photometric_loss(
                image, context, out["inv_depths"], batch["intrinsics"], out["poses"],
                photo_cfg, band=band)
        metrics.update(self_metrics)
        loss = loss + ((1.0 - w) * self_loss if supervised else self_loss)

    if supervised:
        with spans.span("supervised_loss"):
            gt_inv = depth2inv(batch["depth"])
            sup_loss, sup_metrics = supervised_loss(out["inv_depths"], gt_inv, model.supervised,
                                                    band, batch_group())
            metrics.update(sup_metrics)
            loss = loss + w * sup_loss
            if "inv_depths_rgbd" in out:
                # the rgb+d branch's supervision and the feature consistency
                sup_rgbd, _ = supervised_loss(out["inv_depths_rgbd"], gt_inv, model.supervised,
                                              band, batch_group())
                metrics["supervised_loss_rgbd"] = sup_rgbd
                loss = loss + model.weight_rgbd * w * sup_rgbd
                if "depth_loss" in out:
                    metrics["depth_loss"] = out["depth_loss"]
                    loss = loss + out["depth_loss"]

    if model.kind == "VelSupModel":
        vel_loss, vel_metrics = velocity_loss(out["poses"], batch["pose_context"], band)
        metrics.update(vel_metrics)
        loss = loss + model.velocity_loss_weight * vel_loss

    metrics["loss"] = loss
    return loss, (metrics, out)
