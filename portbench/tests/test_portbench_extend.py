"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as new files and entries only: written into a temporary
directory, the harness finds them by name and runs them (on the CPU, at a
tiny size), with no file of the package edited."""

from __future__ import annotations

import json

import torch

from portbench.harness import run_cell
from portbench.tests import tiny

READER = '''"""Steps in the traced window (a test metric)."""


def read(run, trace):
    return float(trace.steps)
'''


def test_new_files_are_found_and_run(tmp_path):
    reg = tiny.write(tmp_path, ("tiny_train",))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "traced_steps.train.py").write_text(READER)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "traced_steps.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "train_images_per_s", "workloads": ["tiny_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = type(reg)(tmp_path / "BENCHMARK.json", [tmp_path])

    out = run_cell(reg, "tiny_train", 2 ** 31 + 3, 0.5, True, torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["metrics"]["traced_steps.train"] == {"value": 2.0, "unit": "steps"}
    assert "host_ms_per_step.train" in out["metrics"]

    out = run_cell(reg, "tiny_train", 7, 0.5, False, torch.device("cpu"))
    assert set(out["metrics"]) == {"train_images_per_s", "peak_mem_mib", "setup_s"}
    assert out["metrics"]["train_images_per_s"]["value"] == out["steps"] * 2 / out["window_s"]
