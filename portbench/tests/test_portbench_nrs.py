"""The NRS train kind (``kinds/nrs_train.py``) on the CPU at a tiny cell:
the NRS recipe at 96x96 (the smallest multiple of 32 whose half holds the
41x41 window), batch 2, in float32 (the reference in float64), progress
0.5. A whole run is correct, and each fault of the kind makes it not
correct; the soft-argmax roofline's launches and the new spans' readers.

The tiny limits, from three seeds on the CPU (the program's readings, then
the faults' smallest): loss_gap 1e-4 (at most 1.0e-6; every fault 5.3e-3
or more), grad1_gap 0.3 (0.077), update_gap 0.5 (0.11), update_median_gap
0.1 (0.014)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.harness import PACKAGE, Registry, run_cell
from portbench.kinds.nrs_train import FAULTS
from portbench.rooflines import softargmax
from portbench.tests import tiny

LIMITS = {"loss_gap": 1e-4, "grad1_gap": 0.3, "update_gap": 0.5, "update_median_gap": 0.1}


def write(directory) -> Registry:
    """A tiny NRS cell, as a later change adds one: its configuration,
    traffic and cell files and a BENCHMARK.json that lists it."""
    tiny.write(directory, ("tiny_train",))
    cfg = json.loads((PACKAGE / "configs/nrs_omnicam.json").read_text())
    cfg["train"]["datasets"]["augmentation"]["image_shape"] = "(96, 96)"
    cfg["train"]["arch"] = {}
    del cfg["batch_dtype"]
    files = {
        "configs/tiny_nrs.json": cfg,
        "traffic/tiny_nrs.json": {"kind": "nrs_train", "batch": 2, "shape": [96, 96],
                                  "contexts": 2, "jitter": [0.2, 0.2, 0.2, 0.05], "pool": 3,
                                  "progress": 0.5},
        "cells/tiny_nrs.json": {"recipe": "train", "precision": "float32",
                                "tf32": {"cudnn": True, "matmul": False}, "trace_steps": 2,
                                "check_steps": 2, "limits": LIMITS},
    }
    for name, body in files.items():
        (directory / name).write_text(json.dumps(body))
    spec = json.loads((directory / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": "tiny_nrs", "config": "tiny_nrs", "traffic": "tiny_nrs",
                          "chips": 1, "why": "CPU test"}]
    full = json.loads((PACKAGE.parent / "BENCHMARK.json").read_text())
    spec["per_layer"] = [dict(m, workloads=["tiny_nrs"]) for m in full["per_layer"]
                         if m.get("workloads") == ["omnicam_train_bf16_b16"]]
    (directory / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(directory / "BENCHMARK.json", [directory])


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return write(tmp_path_factory.mktemp("tiny_nrs"))


def test_a_traced_run_is_correct_and_reports_the_new_metrics(registry):
    out = run_cell(registry, "tiny_nrs", 2 ** 31 + 77, 0.3, True, torch.device("cpu"))
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # the CPU's trace holds no device operation: no roofline to read
    assert "softargmax_roofline_pct.nrs" not in m
    for name in ("train_images_per_s.nrs", "generic_project_host_ms.nrs",
                 "ray_decoder_host_ms.nrs", "mfu.nrs"):
        assert m[name]["value"] > 0, name


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_makes_the_run_incorrect(registry, fault):
    out = run_cell(registry, "tiny_nrs", 2 ** 31 + 77, 0.1, False, torch.device("cpu"),
                   fault=fault)
    assert out["correct"] is False, out["checks"]


def test_the_temperature_fault_leaves_the_program_as_it_was(registry):
    from packnet_sfm_tpu_torch.models import sfm

    original = sfm.projection_temperature
    run_cell(registry, "tiny_nrs", 5, 0.1, False, torch.device("cpu"), fault="temperature_doubled")
    assert sfm.projection_temperature is original


def test_softargmax_bounds_and_roofline_share():
    # PERF.md's kernel table: [1,3,192,192], p = 20: K6f 0.0148 ms (exponentials), K6b 0.0111
    assert softargmax.fwd_s(1, 192, 192, 20) == pytest.approx(14.83e-6, rel=1e-3)
    assert softargmax.bwd_s(1, 192, 192, 20) == pytest.approx(11.10e-6, rel=1e-3)
    launches = softargmax.step_launches(16, 384, 384, 2, 20)
    assert [k for k, _ in launches] == ["softargmax_fwd", "softargmax_bwd"] * 2
    from portbench.harness import Run
    from portbench.trace import Trace

    class Cell:
        def images_per_step(self):
            return 16

        def softargmax_launches(self):
            return launches

    ops, t = [], 0.0
    for _ in range(3):
        for k, s in launches:        # each launch at four times its bound
            ops.append((f"void {k}_kernel(float const*)", t, t + 4 * s * 1e6))
            t += 5 * s * 1e6
    reader = Registry(PACKAGE.parent / "BENCHMARK.json").code("metrics", "softargmax_roofline_pct.nrs")
    run = Run(Cell(), 10, 1.0, 0.1, 1e15)
    assert reader.read(run, Trace.from_records(3, 1.0, ops)) == pytest.approx(25.0)
    assert reader.read(run, Trace.from_records(3, 1.0, ops[:-1])) is None
