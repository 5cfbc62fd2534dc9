"""The ``graph_step_pct.*`` readers (``portbench/graph_steps.py``): in the
tiny CPU train cell, whose steps run eagerly, they read 0; on hand-made
step records the share of the records that replayed the program's CUDA
graph; None where the records have no ``graph_replays`` counter (a program
that counts none)."""

from __future__ import annotations

import json

import pytest
import torch

from packnet_sfm_tpu_torch.engine.spans import Span, StepRecord
from portbench import graph_steps, harness
from portbench.tests import tiny

NAMES = [f"graph_step_pct.{s}" for s in ("train", "host_paced", "unbounded")]
CELLS = {"train": "san_kitti_train_f32_b1", "host_paced": "kitti_train_bf16_b16",
         "unbounded": "kitti_train_bf16_b4"}


def _record(i, **counters):
    return StepRecord(i, [Span("train_step", -1, 0, 1)], dict(copies=1, **counters))


def test_the_benchmark_lists_each_reader_in_its_cell():
    spec = json.loads((harness.PACKAGE.parent / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in spec["per_layer"]}
    moves = {"train": "train_images_per_s", "host_paced": "host_paced_train_images_per_s",
             "unbounded": "peak_mem_mib"}
    for name in NAMES:
        suffix = name.rsplit(".", 1)[1]
        m = listed[name]
        assert m["workloads"] == [CELLS[suffix]] and m["moves"] == moves[suffix]
        assert m["unit"] == "%" and m["source"] == "program_counter"
        assert m["layer"] == "engine.train step dispatch"


@pytest.mark.parametrize("replays,want", [([1, 1, 1, 1], 100.0), ([0, 1, 1, 1], 75.0),
                                          ([0, 0], 0.0), ([1], 100.0)])
def test_the_share_of_hand_made_records(replays, want):
    records = [_record(i, graph_replays=r) for i, r in enumerate(replays)]
    assert graph_steps.share(records) == want


def test_records_without_the_counter_read_none():
    assert graph_steps.share([_record(0), _record(1)]) is None
    assert graph_steps.share([_record(0, graph_replays=1), _record(1)]) is None
    assert graph_steps.share([]) is None


def test_the_tiny_cpu_cell_reads_0(tmp_path, monkeypatch):
    from portbench import spans

    monkeypatch.setattr(spans, "SECONDS", 0.2)
    reg = tiny.write(tmp_path, ("tiny_train",))
    result = harness.run_cell(reg, "tiny_train", 2 ** 31 + 29, 0.3, True, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["metrics"]["graph_step_pct.train"] == {"value": 0.0, "unit": "%"}
