"""The command's refusals: without a card it exits with code 5 and prints
no result, never falling back to the CPU; in a directory that holds only
BENCHMARK.json and the benchmark it exits non-zero with no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from portbench.harness import PACKAGE

ROOT = PACKAGE.parent


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "kitti_train_bf16_b4", "--seed", str(2 ** 31 + 9), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    res = _run(ROOT)
    assert res.returncode == 5, res.stderr[-2000:]
    assert res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
