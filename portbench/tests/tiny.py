"""Tiny cells for the CPU tests, written as files into a directory the way
a later change adds a cell: PackNetSlim01 at 64x96 for the train and eval
kinds, PackNet-SAN01 at 64x96 for completion, each with its configuration,
traffic and cell file, and a BENCHMARK.json that lists them."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.harness import PACKAGE, Registry

ROOT = PACKAGE.parent
LIMITS_TRAIN = {"loss_gap": 1e-3, "grad1_gap": 3e-2, "update_gap": 5e-2}
LIMITS_EVAL = {"metric_gap": 1e-4, "inv_gap": 1e-3}


def write(directory: Path, workloads=("tiny_train", "tiny_san", "tiny_eval")) -> Registry:
    d = Path(directory)
    for sub in ("configs", "traffic", "cells"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    kitti = json.loads((PACKAGE / "configs/packnet01_kitti.json").read_text())
    for recipe in ("train", "eval"):
        kitti[recipe]["model"]["depth_net"]["name"] = "PackNetSlim01"
        kitti[recipe]["datasets"]["augmentation"]["image_shape"] = "(64, 96)"
    kitti["train"]["arch"] = {}
    files = {
        "configs/tiny_kitti.json": kitti,
        "configs/tiny_san.json": json.loads((PACKAGE / "configs/packnet_san_kitti.json").read_text()),
        "traffic/tiny_train.json": {"kind": "train", "batch": 2, "shape": [64, 96], "contexts": 2,
                                    "jitter": [0.2, 0.2, 0.2, 0.05], "pool": 4},
        "traffic/tiny_san.json": {"kind": "train", "batch": 1, "shape": [64, 96], "contexts": 0,
                                  "jitter": [0.2, 0.2, 0.2, 0.05], "pool": 4,
                                  "gt_density": 0.16, "input_density": 0.04},
        "traffic/tiny_eval.json": {"kind": "eval", "batch": 2, "shape": [64, 96],
                                   "gt_shape": [120, 200], "gt_density": 0.1, "pool": 4},
    }
    # float32 with cuDNN TF32 on (a no-op on the CPU): a bfloat16 control
    cell = {"precision": "float32", "tf32": {"cudnn": True, "matmul": False}, "trace_steps": 2}
    files["cells/tiny_train.json"] = dict(cell, recipe="train", limits=LIMITS_TRAIN)
    files["cells/tiny_san.json"] = dict(cell, recipe="train", limits=LIMITS_TRAIN)
    files["cells/tiny_eval.json"] = dict(cell, recipe="eval", limits=LIMITS_EVAL)
    for name, body in files.items():
        (d / name).write_text(json.dumps(body))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config_of = {"tiny_train": "tiny_kitti", "tiny_san": "tiny_san", "tiny_eval": "tiny_kitti"}
    spec["workloads"] = [{"name": w, "config": config_of[w], "traffic": w, "chips": 1,
                          "why": "CPU test"} for w in workloads]
    kind = {"tiny_train": "train", "tiny_san": "train", "tiny_eval": "eval"}
    for group in ("end_to_end", "per_layer"):
        # the tiny train cells stand for the card-paced ones
        spec[group] = [m for m in spec[group]
                       if "host_paced" not in m["name"] and not m["name"].endswith(".unbounded")]
        for m in spec[group]:
            if "workloads" in m:
                suffix = "eval" if m["name"].startswith("eval") or m["name"].endswith(".eval") else "train"
                m["workloads"] = [w for w in workloads if kind[w] == suffix]
    (d / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(d / "BENCHMARK.json", [d])
