"""Config system: attribute-access tree + yaml merge.

The port's own copy of ``packnet_sfm_tpu/core/config.py`` (the port imports
nothing of the JAX package): a single canonical default tree, deep-merged
with a user yaml or dict; dataset lists broadcast to a common length.

The schema mirrors the JAX package key-for-key so the repo's yaml configs
work here unmodified. ``yaml`` is imported inside ``load_config`` only, so
the train paths run where PyYAML is not installed; ``OMNICAM``
(``configs/train_omnicam.yaml``, NRS) and ``KITTI``
(``configs/train_kitti.yaml``, the PackNet01 flagship) are those
configurations as dict literals for that case.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping


class ConfigNode(dict):
    """dict with attribute access and deep merge (yacs-CfgNode equivalent)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any):
        self[key] = value

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v
                for k, v in self.items()}

    @staticmethod
    def from_dict(d: Mapping) -> "ConfigNode":
        node = ConfigNode()
        for k, v in d.items():
            node[k] = ConfigNode.from_dict(v) if isinstance(v, Mapping) else v
        return node


def merge_config(base: ConfigNode, override: Mapping) -> ConfigNode:
    """Deep-merge ``override`` into a clone of ``base`` (reference merge_cfgs,
    utils/config.py:151). Unknown keys are allowed (forward compat)."""
    out = base.clone()
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), ConfigNode):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = ConfigNode.from_dict(v) if isinstance(v, Mapping) else copy.deepcopy(v)
    return out


def get_default_config() -> ConfigNode:
    """Canonical default tree (parity: configs/default_config.py:8-196)."""
    return ConfigNode.from_dict({
        "name": "",
        "debug": False,
        "config": "",
        "prepared": False,
        "arch": {
            "seed": 42,
            "min_epochs": 1,
            "max_epochs": 50,
            "validate_first": False,
            "dtype": "float32",        # TPU addition: compute dtype (float32|bfloat16)
            "grad_accum": 1,           # TPU addition: gradient-accumulation microbatches
            "mesh": {"data": -1},      # TPU addition: device mesh axes (-1 = all chips)
        },
        "checkpoint": {
            "filepath": "",
            "save_top_k": 5,
            "monitor": "loss",
            "monitor_index": 0,
            "mode": "auto",
            "s3_path": "",
            "s3_frequency": 1,
        },
        "save": {
            "folder": "",
            "depth": {"rgb": True, "viz": True, "npz": True, "png": True},
        },
        "wandb": {
            "dry_run": True, "name": "", "project": "", "entity": "",
            "tags": [], "dir": "",
        },
        "model": {
            "name": "",
            "checkpoint_path": "",
            "optimizer": {
                "name": "Adam",
                "depth": {"lr": 0.0002, "weight_decay": 0.0},
                "pose": {"lr": 0.0002, "weight_decay": 0.0},
            },
            "scheduler": {"name": "StepLR", "step_size": 10, "gamma": 0.5, "T_max": 20},
            "params": {
                "crop": "", "min_depth": 0.0, "max_depth": 80.0,
                "scale_output": "resize",
            },
            "loss": {
                "num_scales": 4,
                "progressive_scaling": 0.0,
                "flip_lr_prob": 0.5,
                "rotation_mode": "euler",
                "upsample_depth_maps": False,
                "ssim_loss_weight": 0.85,
                "occ_reg_weight": 0.1,
                "smooth_loss_weight": 0.001,
                "C1": 1e-4,
                "C2": 9e-4,
                "photometric_reduce_op": "min",
                "disp_norm": True,
                "clip_loss": 0.0,
                "padding_mode": "zeros",
                "automask_loss": True,
                "velocity_loss_weight": 0.1,
                "supervised_method": "sparse-l1",
                "supervised_num_scales": 4,
                "supervised_loss_weight": 0.9,
            },
            "depth_net": {"name": "", "checkpoint_path": "", "version": "", "dropout": 0.0,
                          "remat": False, "pretrained_path": ""},
            "pose_net": {"name": "", "checkpoint_path": "", "version": "", "dropout": 0.0,
                         "pretrained_path": ""},
        },
        "datasets": {
            "augmentation": {
                "image_shape": (),
                "jittering": (0.2, 0.2, 0.2, 0.05),
                "crop_train_borders": (),
                "crop_eval_borders": (),
                # TPU-native input pipeline (docs/STATUS.md round-4): ship
                # resized uint8 + per-sample factors, jitter in-graph.
                # False = reference-semantics host jitter (bit-parity path).
                "device_jitter": True,
                # train-resize filter: "area" (cv2 INTER_AREA, 3.4x faster)
                # or "lanczos" (reference-exact). Eval always uses lanczos.
                "resize_filter": "area",
            },
            "train": {
                "batch_size": 8, "num_workers": 16,
                "back_context": 1, "forward_context": 1,
                "dataset": [], "path": [], "split": [],
                "depth_type": [""], "input_depth_type": [""],
                "cameras": [[]], "repeat": [1], "num_logs": 5,
            },
            "validation": {
                "batch_size": 1, "num_workers": 8,
                "back_context": 0, "forward_context": 0,
                "dataset": [], "path": [], "split": [],
                "depth_type": [""], "input_depth_type": [""],
                "cameras": [[]], "num_logs": 5,
            },
            "test": {
                "batch_size": 1, "num_workers": 8,
                "back_context": 0, "forward_context": 0,
                "dataset": [], "path": [], "split": [],
                "depth_type": [""], "input_depth_type": [""],
                "cameras": [[]], "num_logs": 5,
            },
        },
    })


def _broadcast_dataset_lists(d: ConfigNode) -> ConfigNode:
    """Broadcast per-dataset lists to a common length (reference prep_dataset,
    utils/config.py:14-45): every list key grows to len(dataset)."""
    n = len(d.get("dataset", []))
    if n == 0:
        return d
    for key in ("path", "split", "depth_type", "input_depth_type", "cameras", "repeat"):
        if key in d:
            v = d[key]
            if not isinstance(v, list):
                v = [v]
            if len(v) == 1 and n > 1:
                v = v * n
            d[key] = v
    return d


def load_config(path: str) -> ConfigNode:
    """Load a yaml file merged over the defaults (see ``config_from_dict``)."""
    import yaml

    with open(path) as f:
        user = yaml.safe_load(f) or {}
    cfg = config_from_dict(user)
    cfg.config = path
    return cfg


def config_from_dict(user: Mapping) -> ConfigNode:
    """Merge a user dict over the defaults, as ``load_config`` does a yaml.

    Tuple-typed defaults accept yaml string forms like "(192, 640)" the way
    the reference yacs configs write them.
    """
    cfg = merge_config(get_default_config(), user)

    def fix_tuples(node):
        for k, v in node.items():
            if isinstance(v, ConfigNode):
                fix_tuples(v)
            elif isinstance(v, str) and v.startswith("(") and v.endswith(")"):
                try:
                    node[k] = tuple(
                        int(x) if x.strip().isdigit() else float(x)
                        for x in v[1:-1].split(",") if x.strip())
                except ValueError:
                    pass

    fix_tuples(cfg)
    return cfg


def parse_train_config(path_or_cfg) -> ConfigNode:
    """Prepare a config for training (reference parse_train_file semantics,
    utils/config.py:193-285): yaml load + dataset-list broadcasting."""
    cfg = load_config(path_or_cfg) if isinstance(path_or_cfg, str) else path_or_cfg
    for mode in ("train", "validation", "test"):
        _broadcast_dataset_lists(cfg.datasets[mode])
    cfg.prepared = True
    return cfg


# configs/train_omnicam.yaml as ``yaml.safe_load`` returns it: NRS
# self-supervised training (GenericSelfSupModel, RaySurfaceResNet-18 +
# PoseNet, 384x384). tests/test_torch_port_rules.py holds the two equal.
OMNICAM = {
    "arch": {"dtype": "bfloat16"},
    "model": {
        "name": "GenericSelfSupModel",
        "loss": {
            "num_scales": 1,
            "photometric_reduce_op": "mean",
            "automask_loss": False,
            "clip_loss": 0.5,
            "smooth_loss_weight": 0.1,
        },
        "optimizer": {"depth": {"lr": 0.0002}, "pose": {"lr": 0.0002}},
        "scheduler": {"name": "StepLR", "step_size": 30, "gamma": 0.5},
        "depth_net": {"name": "RaySurfaceResNet", "version": "18"},
        "pose_net": {"name": "PoseNet"},
        "params": {"crop": "", "min_depth": 0.0, "max_depth": 80.0},
    },
    "datasets": {
        "augmentation": {"image_shape": "(384, 384)"},
        "train": {
            "batch_size": 1,
            "dataset": ["Image"],
            "path": ["/data/datasets/omnicam"],
            "split": [""],
            "depth_type": [""],
            "repeat": [2],
        },
        "validation": {
            "dataset": ["Image"],
            "path": ["/data/datasets/omnicam"],
            "split": [""],
            "depth_type": [""],
        },
        "test": {
            "dataset": ["Image"],
            "path": ["/data/datasets/omnicam"],
            "split": [""],
            "depth_type": [""],
        },
    },
}


# configs/train_kitti.yaml as ``yaml.safe_load`` returns it: the flagship
# self-supervised training (SelfSupModel, PackNet01-1A + PoseNet, 192x640,
# batch 4). tests/test_torch_port_rules.py holds the two equal.
KITTI = {
    "arch": {"dtype": "bfloat16"},
    "model": {
        "name": "SelfSupModel",
        "optimizer": {"name": "Adam", "depth": {"lr": 0.0002}, "pose": {"lr": 0.0002}},
        "scheduler": {"name": "StepLR", "step_size": 30, "gamma": 0.5},
        "depth_net": {"name": "PackNet01", "version": "1A"},
        "pose_net": {"name": "PoseNet", "version": ""},
        "params": {"crop": "garg", "min_depth": 0.0, "max_depth": 80.0},
    },
    "datasets": {
        "augmentation": {"image_shape": "(192, 640)"},
        "train": {
            "batch_size": 4,
            "dataset": ["KITTI"],
            "path": ["/data/datasets/KITTI_raw"],
            "split": ["data_splits/eigen_zhou_files.txt"],
            "depth_type": ["velodyne"],
            "repeat": [2],
        },
        "validation": {
            "dataset": ["KITTI"],
            "path": ["/data/datasets/KITTI_raw"],
            "split": ["data_splits/eigen_val_files.txt",
                      "data_splits/eigen_test_files.txt"],
            "depth_type": ["velodyne"],
        },
        "test": {
            "dataset": ["KITTI"],
            "path": ["/data/datasets/KITTI_raw"],
            "split": ["data_splits/eigen_test_files.txt"],
            "depth_type": ["velodyne"],
        },
    },
}


def _synthetic_split(batch_size: int, length: int, **extra) -> dict:
    return {"batch_size": batch_size, "dataset": ["Synthetic"], "path": [""], "split": [""],
            "depth_type": [""], "synthetic_length": length, **extra}


# configs/overfit_synthetic.yaml as ``yaml.safe_load`` returns it: the
# overfit-to-a-bar recipe (SelfSupModel, DepthResNet-18 + PoseNet, 64x96
# Synthetic, batch 8, 32 samples repeated 24 times, 8 epochs).
# tests/test_torch_port_rules.py holds the two equal.
OVERFIT_SYNTHETIC = {
    "arch": {"max_epochs": 8},
    "checkpoint": {"monitor": "depth_gt_abs_rel", "mode": "min"},
    "model": {
        "name": "SelfSupModel",
        "depth_net": {"name": "DepthResNet", "version": "18"},
        "pose_net": {"name": "PoseNet"},
    },
    "datasets": {
        "train": _synthetic_split(8, 32, repeat=[24]),
        "validation": _synthetic_split(8, 16),
        "test": _synthetic_split(8, 16),
    },
}


# configs/overfit_packnet_synthetic.yaml as ``yaml.safe_load`` returns it:
# the same recipe with PackNetSlim01-1A at lr 5e-5.
OVERFIT_PACKNET_SYNTHETIC = {
    "arch": {"max_epochs": 8},
    "checkpoint": {"monitor": "depth_gt_abs_rel", "mode": "min"},
    "model": {
        "name": "SelfSupModel",
        "optimizer": {"depth": {"lr": 5e-05}, "pose": {"lr": 5e-05}},
        "depth_net": {"name": "PackNetSlim01", "version": "1A"},
        "pose_net": {"name": "PoseNet"},
    },
    "datasets": {
        "train": _synthetic_split(8, 32, repeat=[24]),
        "validation": _synthetic_split(8, 16),
        "test": _synthetic_split(8, 16),
    },
}
