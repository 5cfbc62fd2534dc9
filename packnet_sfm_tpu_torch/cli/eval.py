"""Eval CLI (port of ``packnet_sfm_tpu/cli/eval.py``)::

    python -m packnet_sfm_tpu_torch.cli.eval --checkpoint <dir> [--config <yaml>]
        [--device cuda|cpu]

Restores a checkpoint directory (``engine/checkpoint.py``), with the config
embedded in its meta.json and an optional yaml merged over it (PyYAML is
imported only then; ``evaluate`` also takes that config as a dict, such as
``core/config.EVAL_KITTI``, for hosts without PyYAML), runs the test split
through ``Trainer.test`` and prints the metric tables. Runs on the card
unless ``--device cpu`` is given. ``--half`` sets ``arch.dtype: bfloat16``, as the JAX CLI does: the model
computes in bfloat16 where its networks take a dtype (``engine/factory.
setup_model``; PackNet-SAN and the ResNet family take none and compute in
float32, as in the JAX package); a checkpoint whose config says bfloat16
evaluates so without it. A completion model (PackNet-SAN) evaluates with
the test split's input depth where the split names one (``input_depth_type``:
its rgb+d rows), else on rgb alone.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PackNet-SfM evaluation (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", type=str, default=None,
                        help="optional yaml overriding the embedded config")
    parser.add_argument("--half", action="store_true",
                        help="evaluate with bfloat16 compute")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def evaluate(checkpoint: str, config_path=None, half=False, device="cuda"):
    """The test split's metric tables ([{mode: [7]}], one per dataset) of
    the checkpoint's model. ``config_path``, a yaml path or a dict, is
    filled in from the defaults and merged over the checkpoint's config."""
    from packnet_sfm_tpu_torch.core.config import (
        ConfigNode, config_from_dict, load_config, merge_config, parse_train_config)
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    with open(os.path.join(checkpoint, "meta.json")) as f:
        meta = json.load(f)
    config = ConfigNode.from_dict(meta["config"])
    if isinstance(config_path, Mapping):
        config = merge_config(config, config_from_dict(config_path).to_dict())
    elif config_path:
        config = merge_config(config, load_config(config_path).to_dict())
    if half:
        config.arch.dtype = "bfloat16"
    config = parse_train_config(config)

    trainer = Trainer(config, device=device)
    trainer.resume(checkpoint)
    return trainer.test()


def main(argv=None):
    args = parse_args(argv)
    evaluate(args.checkpoint, args.config, args.half, args.device)


if __name__ == "__main__":
    main()
