"""Train CLI (port of ``packnet_sfm_tpu/cli/train.py``)::

    python -m packnet_sfm_tpu_torch.cli.train <config.yaml | checkpoint dir>
        [--profile-dir <dir>] [--device cuda|cpu] [--distributed]

One positional argument: a yaml config for a fresh run, or a checkpoint
directory to resume (its meta.json holds the config; the model, optimizer,
schedule, step and flip generator are restored and training goes on at the
next epoch). ``--profile-dir`` traces epoch 1 with ``torch.profiler``.
Runs on the card unless ``--device cpu`` is given. The last line printed
is ``{"history": [...]}``, one record an epoch (``Trainer.fit``'s: loss,
images/s, train and validation seconds, peak MiB on the card, the metric
tables). ``train`` also takes the config as a dict (merged over the
defaults), for hosts without PyYAML.

``--distributed`` trains with one process a rank, launched by
``torch.distributed.run``, which sets RANK, WORLD_SIZE and LOCAL_RANK::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m packnet_sfm_tpu_torch.cli.train <config> --distributed

Rank r trains on ``cuda:LOCAL_RANK`` over NCCL, and raises where that card
is not there; ``--device cpu`` trains on the CPU over gloo. ``batch_size``
is each rank's: the global batch is N times it. The last line is printed
by rank 0. (NCCL refuses two ranks on one card; ``train(...,
device="cuda:0", backend="gloo")`` puts them there.)
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
                        help="one process a rank, under torch.distributed.run")
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


def train(file, distributed: bool = False, profile_dir=None, device="cuda", backend=None):
    """Train from a yaml path, a config dict or a checkpoint directory;
    returns the ``Trainer`` after ``fit``. ``distributed`` joins the
    process group first (``parallel/mesh.init_distributed``: this rank's
    card, or the CPU) unless this process has joined one already."""
    if distributed:
        from packnet_sfm_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(backend, device)
    trainer = build_trainer(file, profile_dir, device)
    trainer.fit()
    return trainer


def main(argv=None):
    from packnet_sfm_tpu_torch.parallel.mesh import process_index, shutdown

    args = parse_args(argv)
    trainer = train(args.file, args.distributed, args.profile_dir, args.device)
    if process_index() == 0:
        print(json.dumps({"history": trainer.history}))
    if args.distributed:
        shutdown()


if __name__ == "__main__":
    main()
