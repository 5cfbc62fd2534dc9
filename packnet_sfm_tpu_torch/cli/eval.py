"""Eval CLI (port of ``packnet_sfm_tpu/cli/eval.py``)::

    python -m packnet_sfm_tpu_torch.cli.eval --checkpoint <dir> [--config <yaml>]
        [--device cuda|cpu]

Restores a checkpoint directory (``engine/checkpoint.py``), with the config
embedded in its meta.json and an optional yaml merged over it (PyYAML is
imported only then), runs the test split through ``Trainer.test`` and prints
the metric tables. Runs on the card unless ``--device cpu`` is given.
``--half`` (bfloat16) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PackNet-SfM evaluation (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", type=str, default=None,
                        help="optional yaml overriding the embedded config")
    parser.add_argument("--half", action="store_true",
                        help="evaluate with bfloat16 compute (not ported yet)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def evaluate(checkpoint: str, config_path=None, half=False, device="cuda"):
    """The test split's metric tables ([{mode: [7]}], one per dataset) of
    the checkpoint's model."""
    from packnet_sfm_tpu_torch.core.config import (
        ConfigNode, load_config, merge_config, parse_train_config)
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    if half:
        raise NotImplementedError("--half (bfloat16) is not ported yet; see ROADMAP.md §1 item 3")
    with open(os.path.join(checkpoint, "meta.json")) as f:
        meta = json.load(f)
    config = ConfigNode.from_dict(meta["config"])
    if config_path:
        config = merge_config(config, load_config(config_path).to_dict())
    config = parse_train_config(config)

    trainer = Trainer(config, device=device)
    trainer.resume(checkpoint)
    return trainer.test()


def main(argv=None):
    args = parse_args(argv)
    evaluate(args.checkpoint, args.config, args.half, args.device)


if __name__ == "__main__":
    main()
