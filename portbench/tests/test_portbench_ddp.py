"""The data-parallel train kind (``kinds/ddp_train.py``) on the CPU: a
whole run of a tiny cell (PackNetSlim01 at 64x96, 4 gloo ranks of one
sample each, float32) in a fresh process under a hard timeout: the first
steps' loss and gradient agree with the reference on the global batch of 4,
every rank holds rank 0's weights bit for bit after them, every rank has
exited by the end, and the reader of the all-reduce finds no device
operation to read. Marked slow: it takes about 75 s on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness import PACKAGE

ROOT = PACKAGE.parent


@pytest.mark.slow          # ~75 s: three more processes start and set up their ranks
def test_four_gloo_ranks_agree_with_the_reference(tmp_path):
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.harness import Registry, run_cell
from portbench.tests import tiny
torch.set_num_threads(1)
d = Path({str(tmp_path)!r})
tiny.write(d, ("tiny_train",))
(d / "traffic/tiny_ddp.json").write_text(json.dumps({{
    "kind": "ddp_train", "batch": 1, "ranks": 4, "shape": [64, 96], "contexts": 2,
    "jitter": [0.2, 0.2, 0.2, 0.05], "pool": 2}}))
(d / "cells/tiny_ddp.json").write_text(json.dumps({{
    "recipe": "train", "precision": "float32", "tf32": {{"cudnn": True, "matmul": False}},
    "trace_steps": 2, "check_steps": 2,
    "limits": dict(tiny.LIMITS_TRAIN, rank_weight_mismatch=0)}}))
spec = json.loads((d / "BENCHMARK.json").read_text())
spec["workloads"] = [{{"name": "tiny_ddp", "config": "tiny_kitti", "traffic": "tiny_ddp",
                       "chips": 4, "why": "CPU test"}}]
full = json.loads((Path({str(ROOT)!r}) / "BENCHMARK.json").read_text())
spec["per_layer"] = [dict(m, workloads=["tiny_ddp"]) for m in full["per_layer"]
                     if m.get("workloads") == ["kitti_train_ddp4_b4"]]
(d / "BENCHMARK.json").write_text(json.dumps(spec))
reg = Registry(d / "BENCHMARK.json", [d])
out = run_cell(reg, "tiny_ddp", 2 ** 31 + 99, 0.5, True, torch.device("cpu"))
print("RESULT", json.dumps({{"correct": out["correct"], "checks": out["checks"],
                            "metrics": out["metrics"]}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_weight_mismatch"] == [0.0, 0]
    assert out["checks"]["loss_gap"][0] < 1e-4
    assert "peak MiB by rank [0.0, 0.0, 0.0, 0.0]" in res.stderr
    m = out["metrics"]
    assert m["train_images_per_s.ddp4"]["value"] > 0 and m["host_ms_per_step.ddp4"]["value"] > 0
    assert "allreduce_device_ms.ddp4" not in m
