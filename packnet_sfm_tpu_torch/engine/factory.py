"""Config -> model/optimizer factories (port of ``engine/factory.py``).

Every network and model kind of the JAX package: the PackNet01,
PackNetSlim01, PackNetSAN01, DepthResNet and RaySurfaceResNet depth
networks, PoseNet and PoseResNet, the kinds of ``models/sfm.MODEL_KINDS``,
and the StepLR and CosineAnnealingLR schedules. An unknown name raises
``ValueError``, as in the JAX package.

``dtype`` is the compute dtype (None: float32), passed as the JAX package
passes it: to PackNet01, PackNetSlim01 and PoseNet only. The ResNet family
and PackNetSAN01 take none and compute in float32 on any input. Parameters
stay float32 whatever it is.
"""

from __future__ import annotations

import math

import torch

from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.engine.metrics import DepthMetricsConfig
from packnet_sfm_tpu_torch.losses.generic_photometric import GenericPhotometricConfig
from packnet_sfm_tpu_torch.losses.photometric import MultiViewPhotometricConfig
from packnet_sfm_tpu_torch.losses.supervised import SupervisedLossConfig
from packnet_sfm_tpu_torch.models.sfm import MODEL_KINDS, SUPERVISED_KINDS, SfmModelDef
from packnet_sfm_tpu_torch.nn.depth_resnet import DepthResNet
from packnet_sfm_tpu_torch.nn.packnet import PackNet01, PackNetSlim01
from packnet_sfm_tpu_torch.nn.packnet_san import PackNetSAN01
from packnet_sfm_tpu_torch.nn.pose_resnet import PoseResNet
from packnet_sfm_tpu_torch.nn.posenet import PoseNet
from packnet_sfm_tpu_torch.nn.raysurface import RaySurfaceResNet


def setup_depth_net(cfg: ConfigNode, dtype=None):
    version = cfg.get("version", "")
    dropout = cfg.get("dropout", 0.0) or None
    if cfg.name in ("PackNet01", "PackNetSlim01"):
        net = PackNet01 if cfg.name == "PackNet01" else PackNetSlim01
        return net(version=version[1:] or "A", dropout=dropout,
                   remat=bool(cfg.get("remat", False)), dtype=dtype)
    if cfg.name == "PackNetSAN01":
        return PackNetSAN01(version=version[1:] or "A", dropout=dropout)
    if cfg.name == "DepthResNet":
        return DepthResNet(version=version.replace("pt", "") or "18")
    if cfg.name == "RaySurfaceResNet":
        return RaySurfaceResNet(version=version.replace("pt", "") or "18")
    raise ValueError(f"Unknown depth net {cfg.name}")


def setup_pose_net(cfg: ConfigNode, dtype=None):
    if cfg.name == "PoseNet":
        return PoseNet(dtype=dtype)
    if cfg.name == "PoseResNet":
        return PoseResNet(version=cfg.get("version", "").replace("pt", "") or "18")
    if cfg.name in ("", None):
        return None
    raise ValueError(f"Unknown pose net {cfg.name}")


def setup_model(cfg: ConfigNode, device="cuda", seed: int = 0, dtype=None) -> SfmModelDef:
    """Build the SfmModelDef of config.model on ``device``, computing in
    ``dtype`` where the network takes one (see the module docstring).

    As in the JAX package, ``SfmModel`` builds a pose net only where one is
    named, and the supervised kinds at ``supervised_loss_weight`` >= 1 none
    at all: their loss has no photometric term. Weights are drawn on the
    CPU from ``torch.Generator().manual_seed(seed)`` with the JAX package's
    initializers, then moved to ``device``.
    """
    device = resolve_device(device)
    if cfg.name not in MODEL_KINDS:
        raise ValueError(f"Unknown model {cfg.name}")
    loss = cfg.loss
    gen = torch.Generator().manual_seed(seed)
    depth_net = setup_depth_net(cfg.depth_net, dtype)
    depth_net.init_weights(gen)
    needs_pose = cfg.name != "SfmModel" or cfg.pose_net.get("name")
    if cfg.name in SUPERVISED_KINDS and loss.supervised_loss_weight >= 1.0:
        needs_pose = False
    pose_net = setup_pose_net(cfg.pose_net, dtype) if needs_pose else None
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
    input_keys = (("rgb", "input_depth", "intrinsics")
                  if cfg.name == "SemiSupCompletionModel" else ("rgb",))
    model = SfmModelDef(depth_net, pose_net, kind=cfg.name, photometric=photometric,
                        generic_photometric=generic_photometric,
                        supervised=SupervisedLossConfig(
                            supervised_method=loss.supervised_method,
                            supervised_num_scales=loss.supervised_num_scales),
                        supervised_loss_weight=loss.supervised_loss_weight,
                        velocity_loss_weight=loss.velocity_loss_weight,
                        weight_rgbd=loss.get("weight_rgbd", 1.0),
                        rotation_mode=loss.rotation_mode,
                        flip_lr_prob=loss.flip_lr_prob,
                        upsample_depth_maps=loss.upsample_depth_maps,
                        input_keys=input_keys)
    return model.to(device)


def compute_dtype(config: ConfigNode):
    """``arch.dtype`` as a torch dtype: bfloat16, or else None (float32), as
    the JAX trainer reads it."""
    return torch.bfloat16 if config.arch.get("dtype") == "bfloat16" else None


def setup_metrics_config(cfg: ConfigNode) -> DepthMetricsConfig:
    p = cfg.model.params
    return DepthMetricsConfig(crop=p.crop, min_depth=p.min_depth, max_depth=p.max_depth,
                              scale_output=p.scale_output)


def make_optimizer(model: SfmModelDef, optimizer_cfg: ConfigNode,
                   scheduler_cfg: ConfigNode, steps_per_epoch: int):
    """Adam with separate depth and pose parameter groups, and the epoch
    schedule as a per-step factor of the base rate, as the JAX package's
    optax schedules see the update count k:

    - StepLR: gamma^((k // steps_per_epoch) // step_size);
    - CosineAnnealingLR: optax's ``cosine_decay_schedule`` over T_max
      epochs, 0.5 (1 + cos(pi min(k, n) / n)) with n = T_max *
      steps_per_epoch, held at 0 after n steps (``torch.optim.lr_scheduler.
      CosineAnnealingLR`` would climb back up).

    Call ``scheduler.step()`` after every optimizer step, so that step k
    runs at factor(k). Returns (optimizer, scheduler).

    On a CUDA device Adam is ``capturable``: its step counts and its bias
    corrections stay on the device, and each group's rate is a float32
    tensor there, which the schedule fills in place, so that a train step
    captured as a CUDA graph (``engine/train.make_train_step``) reads the
    rate of the step it replays. A state loaded into it (``load_state_dict``)
    is brought back to that form. On the CPU it is torch's default Adam with
    Python float rates.
    """
    if optimizer_cfg.get("name", "Adam").lower() != "adam":
        raise ValueError(f"Unknown optimizer {optimizer_cfg.get('name')}")
    name = scheduler_cfg.get("name", "StepLR")
    spe = max(steps_per_epoch, 1)
    if name == "StepLR":
        def factor(step: int) -> float:
            return scheduler_cfg.gamma ** ((step // spe) // scheduler_cfg.step_size)
    elif name == "CosineAnnealingLR":
        decay_steps = scheduler_cfg.T_max * spe
        if not decay_steps > 0:
            raise ValueError(f"CosineAnnealingLR needs T_max > 0, got {scheduler_cfg.T_max}")

        def factor(step: int) -> float:
            return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
    else:
        raise ValueError(f"Unknown scheduler {name}")
    groups = [{"params": list(model.depth_net.parameters()),
               "lr": optimizer_cfg.depth.lr,
               "weight_decay": optimizer_cfg.depth.get("weight_decay", 0.0)}]
    if model.pose_net is not None:
        groups.append({"params": list(model.pose_net.parameters()),
                       "lr": optimizer_cfg.pose.lr,
                       "weight_decay": optimizer_cfg.pose.get("weight_decay", 0.0)})
    device = groups[0]["params"][0].device
    if device.type != "cuda":
        optimizer = torch.optim.Adam(groups)
        return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    for group in groups:
        # the schedule's base rate stays a Python float, so that it computes
        # each step's rate on the host and fills the tensor with it
        group["initial_lr"] = group["lr"]
    optimizer = torch.optim.Adam(groups, capturable=True)
    _capturable_on(optimizer, device)
    optimizer.register_load_state_dict_post_hook(lambda opt: _capturable_on(opt, device))
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def _capturable_on(optimizer: torch.optim.Optimizer, device: torch.device) -> None:
    """Every group ``capturable`` with its rate a float32 tensor on ``device``
    and every step count there: what a loaded state (a checkpoint read on
    the CPU, or saved by an Adam on the CPU) is brought back to."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        lr = group["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device == device):
            group["lr"] = torch.as_tensor(lr, dtype=torch.float32).to(device)
    for state in optimizer.state.values():
        if "step" in state:
            state["step"] = state["step"].to(device=device, dtype=torch.float32)
