"""The check catches a broken timed path: a whole run (past the look for a
card, on the CPU at a tiny size) with the program broken underneath comes
out not correct, once for each fault its kind can have; unbroken it comes
out correct."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import run_cell
from portbench.tests import tiny

CASES = [("tiny_train", None, True), ("tiny_train", "state_unchanged", False),
         ("tiny_train", "half_batch", False),
         ("tiny_eval", None, True), ("tiny_eval", "half_batch", False),
         ("tiny_eval", "answer_altered", False)]


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload,fault,correct", CASES)
def test_fault_makes_the_run_incorrect(registry, workload, fault, correct):
    out = run_cell(registry, workload, 2 ** 31 + 17, 0.3, False, torch.device("cpu"), fault=fault)
    assert out["correct"] is correct, out["checks"]
