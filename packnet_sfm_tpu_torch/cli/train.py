"""Train CLI (port of ``packnet_sfm_tpu/cli/train.py``)::

    python -m packnet_sfm_tpu_torch.cli.train <config.yaml | checkpoint dir>
        [--profile-dir <dir>] [--device cuda|cpu]

One positional argument: a yaml config for a fresh run, or a checkpoint
directory to resume (its meta.json holds the config; the model, optimizer,
schedule, step and flip generator are restored and training goes on at the
next epoch). ``--profile-dir`` traces epoch 1 with ``torch.profiler``.
Runs on the card unless ``--device cpu`` is given. The last line printed
is ``{"history": [...]}``, one record an epoch (``Trainer.fit``'s: loss,
images/s, train and validation seconds, peak MiB on the card, the metric
tables). ``train`` also takes the config as a dict (merged over the
defaults), for hosts without PyYAML.
``--distributed`` (multi-process training) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PackNet-SfM training (PyTorch port)")
    parser.add_argument("file", type=str,
                        help="yaml config for a fresh run, or .ckpt dir to resume")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process training (not ported yet)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of epoch 1 there")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not (args.file.endswith((".ckpt", ".yaml")) or os.path.isdir(args.file)):
        parser.error("must provide a .yaml config or checkpoint dir")
    return args


def build_trainer(file, profile_dir=None, device="cuda"):
    """The ``Trainer`` of a yaml path, a config dict or a checkpoint
    directory (restored from it), before ``fit``."""
    from packnet_sfm_tpu_torch.core.config import (
        ConfigNode,
        config_from_dict,
        parse_train_config,
    )
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    resume_path = None
    if isinstance(file, Mapping):
        config = parse_train_config(config_from_dict(file))
    elif os.path.isdir(file) or file.endswith(".ckpt"):
        with open(os.path.join(file, "meta.json")) as f:
            meta = json.load(f)
        config = parse_train_config(ConfigNode.from_dict(meta["config"]))
        resume_path = file
    else:
        config = parse_train_config(file)

    trainer = Trainer(config, device=device, profile_dir=profile_dir)
    if resume_path:
        trainer.resume(resume_path)
    return trainer


def train(file, distributed: bool = False, profile_dir=None, device="cuda"):
    """Train from a yaml path, a config dict or a checkpoint directory;
    returns the ``Trainer`` after ``fit``."""
    if distributed:
        raise NotImplementedError(
            "--distributed (multi-process training) is not ported yet; see ROADMAP.md §1 item 5")
    trainer = build_trainer(file, profile_dir, device)
    trainer.fit()
    return trainer


def main(argv=None):
    args = parse_args(argv)
    trainer = train(args.file, args.distributed, args.profile_dir, args.device)
    print(json.dumps({"history": trainer.history}))


if __name__ == "__main__":
    main()
