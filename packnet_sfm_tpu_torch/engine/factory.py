"""Config -> model/optimizer factories (port of ``engine/factory.py``).

Ported: the PackNet01, PackNetSlim01 and RaySurfaceResNet depth networks,
PoseNet, and the SelfSupModel and GenericSelfSupModel kinds; other networks
and kinds raise ``NotImplementedError`` until their slice lands (ROADMAP.md).
"""

from __future__ import annotations

import torch

from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.engine.metrics import DepthMetricsConfig
from packnet_sfm_tpu_torch.losses.generic_photometric import GenericPhotometricConfig
from packnet_sfm_tpu_torch.losses.photometric import MultiViewPhotometricConfig
from packnet_sfm_tpu_torch.models.sfm import PORTED_KINDS, SfmModelDef
from packnet_sfm_tpu_torch.nn.packnet import PackNet01, PackNetSlim01
from packnet_sfm_tpu_torch.nn.posenet import PoseNet
from packnet_sfm_tpu_torch.nn.raysurface import RaySurfaceResNet


def setup_depth_net(cfg: ConfigNode):
    version = cfg.get("version", "")
    if cfg.name in ("PackNet01", "PackNetSlim01"):
        net = PackNet01 if cfg.name == "PackNet01" else PackNetSlim01
        return net(version=version[1:] or "A", dropout=cfg.get("dropout", 0.0) or None,
                   remat=bool(cfg.get("remat", False)))
    if cfg.name == "RaySurfaceResNet":
        return RaySurfaceResNet(version=cfg.get("version", "").replace("pt", "") or "18")
    raise NotImplementedError(f"depth net {cfg.name!r} is not ported yet; see ROADMAP.md")


def setup_pose_net(cfg: ConfigNode):
    if cfg.name == "PoseNet":
        return PoseNet()
    if cfg.name in ("", None):
        return None
    raise NotImplementedError(f"pose net {cfg.name!r} is not ported yet; see ROADMAP.md")


def setup_model(cfg: ConfigNode, device="cuda", seed: int = 0) -> SfmModelDef:
    """Build the SfmModelDef of config.model on ``device``.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    with the JAX package's initializers, then moved to ``device``.
    """
    device = resolve_device(device)
    if cfg.name not in PORTED_KINDS:
        raise NotImplementedError(f"model {cfg.name!r} is not ported yet; see ROADMAP.md")
    loss = cfg.loss
    gen = torch.Generator().manual_seed(seed)
    depth_net = setup_depth_net(cfg.depth_net)
    depth_net.init_weights(gen)
    pose_net = setup_pose_net(cfg.pose_net)
    if pose_net is not None:
        pose_net.init_weights(gen)
    knobs = dict(
        ssim_loss_weight=loss.ssim_loss_weight,
        smooth_loss_weight=loss.smooth_loss_weight,
        photometric_reduce_op=loss.photometric_reduce_op,
        clip_loss=loss.clip_loss,
        automask_loss=loss.automask_loss,
        padding_mode=loss.padding_mode,
    )
    photometric = MultiViewPhotometricConfig(num_scales=loss.num_scales, C1=loss.C1,
                                             C2=loss.C2, **knobs)
    generic_photometric = None
    if cfg.name.startswith("Generic"):
        generic_photometric = GenericPhotometricConfig(num_scales=1, **knobs)
    model = SfmModelDef(depth_net, pose_net, kind=cfg.name, photometric=photometric,
                        generic_photometric=generic_photometric,
                        rotation_mode=loss.rotation_mode,
                        flip_lr_prob=loss.flip_lr_prob,
                        upsample_depth_maps=loss.upsample_depth_maps)
    return model.to(device)


def setup_metrics_config(cfg: ConfigNode) -> DepthMetricsConfig:
    p = cfg.model.params
    return DepthMetricsConfig(crop=p.crop, min_depth=p.min_depth, max_depth=p.max_depth,
                              scale_output=p.scale_output)


def make_optimizer(model: SfmModelDef, optimizer_cfg: ConfigNode,
                   scheduler_cfg: ConfigNode, steps_per_epoch: int):
    """Adam with separate depth and pose parameter groups, and the StepLR
    epoch decay as a per-step schedule: lr = base * gamma^(epoch //
    step_size), epoch = step // steps_per_epoch. Call ``scheduler.step()``
    after every optimizer step. Returns (optimizer, scheduler).
    """
    if optimizer_cfg.get("name", "Adam").lower() != "adam":
        raise ValueError(f"Unknown optimizer {optimizer_cfg.get('name')}")
    name = scheduler_cfg.get("name", "StepLR")
    if name != "StepLR":
        raise NotImplementedError(f"scheduler {name!r} is not ported yet; see ROADMAP.md")
    groups = [{"params": list(model.depth_net.parameters()),
               "lr": optimizer_cfg.depth.lr,
               "weight_decay": optimizer_cfg.depth.get("weight_decay", 0.0)}]
    if model.pose_net is not None:
        groups.append({"params": list(model.pose_net.parameters()),
                       "lr": optimizer_cfg.pose.lr,
                       "weight_decay": optimizer_cfg.pose.get("weight_decay", 0.0)})
    optimizer = torch.optim.Adam(groups)
    spe = max(steps_per_epoch, 1)

    def factor(step: int) -> float:
        return scheduler_cfg.gamma ** ((step // spe) // scheduler_cfg.step_size)

    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
