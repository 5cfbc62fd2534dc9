"""The metrics that read the program's spans (``portbench/spans.py``), on the
CPU: each reads a number in a tiny train cell and in a tiny eval cell; the
recorded window runs once a run however many readers ask; a reader gives
None where its spans are missing (a program without the recorder, a step
that opens none, a trace without them); the idle readers count a gap by
the span its midpoint falls in."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from portbench import harness, spans
from portbench.harness import Run
from portbench.tests import tiny
from portbench.trace import Trace

HOST = ("batch_copy_host_ms", "forward_host_ms", "backward_host_ms", "optimizer_host_ms")
TRAIN = [f"{b}.{s}" for b in HOST for s in ("train", "host_paced", "unbounded")]
IDLE = [f"{b}.{s}" for b in ("dispatch_idle_ms", "copy_idle_ms")
        for s in ("host_paced", "unbounded")]
NEW = TRAIN + IDLE + ["batch_copy_host_ms.eval"]


class FakeCell:
    min_steps = 1
    pool = [None]

    def __init__(self):
        self.calls = []

    def images_per_step(self):
        return 1

    def step(self, i):
        self.calls.append(i)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """A traced run of the tiny train cell and of the tiny eval cell: (the
    result, the run, the trace, the recorded windows made) of each."""
    d = tmp_path_factory.mktemp("cells")
    reg = tiny.write(d, ("tiny_train", "tiny_eval"))
    made = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(spans, "SECONDS", 0.2)
        record = spans._record

        def counted(run):
            made[run] = made.get(run, 0) + 1
            return record(run)

        patch.setattr(spans, "_record", counted)
        runs, traces = [], []
        patch.setattr(harness, "Run", lambda *a: runs.append(Run(*a)) or runs[-1])
        traced = harness.traced_window
        patch.setattr(harness, "traced_window",
                      lambda *a: traces.append(traced(*a)) or traces[-1])
        out = {}
        for w in ("tiny_train", "tiny_eval"):
            result = harness.run_cell(reg, w, 2 ** 31 + 17, 0.3, True, torch.device("cpu"))
            out[w] = (result, runs[-1], traces[-1], made.get(runs[-1], 0))
    return out


def _read(name, run, trace):
    return harness.Registry(harness.PACKAGE.parent / "BENCHMARK.json").code(
        "metrics", name).read(run, trace)


def test_the_benchmark_lists_each_new_metric_in_its_cells():
    spec = json.loads((harness.PACKAGE.parent / "BENCHMARK.json").read_text())
    cells = {"train": "san_kitti_train_f32_b1", "host_paced": "kitti_train_bf16_b16",
             "unbounded": "kitti_train_bf16_b4", "eval": "kitti_eval_f32_b4"}
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert listed[name]["workloads"] == [cells[name.rsplit(".", 1)[1]]], name
        want = "device_trace" if name in IDLE else "program_span"
        assert listed[name]["source"] == want and listed[name]["unit"] == "ms"


@pytest.mark.parametrize("cell,names", [
    ("tiny_train", [n for n in TRAIN if n.endswith(".train")]),
    ("tiny_eval", ["batch_copy_host_ms.eval"])])
def test_the_cells_report_the_span_metrics(tiny_runs, cell, names):
    result, *_ = tiny_runs[cell]
    assert result["correct"], result["checks"]
    for name in names:
        value = result["metrics"][name]
        assert value["unit"] == "ms" and value["value"] > 0, name


@pytest.mark.parametrize("name", TRAIN)
def test_each_host_reader_reads_the_train_cells_window(tiny_runs, name):
    _, run, trace, _ = tiny_runs["tiny_train"]
    value = _read(name, run, trace)
    assert value is not None and value > 0
    assert value == run.spans_window.host_ms(name.split("_host_ms")[0].replace(
        "optimizer", "optimizer_step"))


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_eval"])
def test_the_recorded_window_runs_once_a_run(tiny_runs, cell):
    _, run, trace, made = tiny_runs[cell]
    assert made == 1
    window = spans.recorded(run)
    assert window is run.spans_window and window.steps >= spans.MIN_STEPS
    root = "train_step" if cell == "tiny_train" else "eval_step"
    assert window.host_ms(root) <= window.ms_per_step()
    assert all(r.spans[0].name == root for r in window.records)


def test_the_step_parts_cover_the_train_step(tiny_runs):
    _, run, _, _ = tiny_runs["tiny_train"]
    window = run.spans_window
    parts = sum(window.host_ms(n) for n in ("batch_copy", "forward", "backward",
                                            "optimizer_step"))
    assert 0.5 * window.host_ms("train_step") < parts <= window.host_ms("train_step")


@pytest.mark.parametrize("name", IDLE)
def test_each_idle_reader_reads_gaps_inside_its_spans(tiny_runs, name):
    """The CPU trace has no device operation (None); with two device
    operations laid 2 us apart inside the traced span, the reader reads
    that gap over the traced steps."""
    _, _, trace, _ = tiny_runs["tiny_train"]
    assert _read(name, None, trace) is None
    span = "batch_copy" if name.startswith("copy") else "backward"
    named = trace.gaps_named
    s, e = next((s, e) for n, s, e, _ in named.host_ops if n == span)
    assert e - s > 4
    named.device_ops = [("k", s, s + 1), ("k", s + 3, s + 4)]
    try:
        assert _read(name, None, trace) == pytest.approx(2 / 1e3 / named.steps)
    finally:
        named.device_ops = []


def test_idle_gaps_are_counted_by_the_span_at_their_middle():
    ops = [("a", 0, 10), ("b", 20, 30), ("c", 50, 60), ("d", 100, 110), ("e", 111, 120)]
    host = [("train_step", 0, 130, 0), ("batch_copy", 5, 16, 1), ("forward", 16, 70, 1),
            ("backward", 70, 99, 1), ("optimizer_step", 99, 130, 1)]
    tr = Trace.from_records(2, 1.0, ops, host_ops=host)
    # gaps 10-20 (middle 15, batch_copy), 30-50 (forward), 60-100 (middle 80,
    # backward), 110-111 (optimizer_step)
    assert spans.idle_ms_in(tr, ("batch_copy",)) == pytest.approx(10 / 1e3 / 2)
    assert spans.idle_ms_in(tr, ("forward", "backward", "optimizer_step")) == pytest.approx(
        (20 + 40 + 1) / 1e3 / 2)
    assert spans.idle_ms_in(tr, ("depth_net",)) is None
    assert spans.idle_ms_in(Trace.from_records(2, 1.0, [], host_ops=host), ("forward",)) is None


def test_no_spans_no_reading(monkeypatch):
    # a step that opens no span of the program
    run = Run(FakeCell(), 10, 1.0, 0.5, 1e15)
    assert _read("forward_host_ms.train", run, None) is None
    assert run.cell.calls == [1 + 10 + i for i in range(max(spans.MIN_STEPS, 50))]
    # a program without the recorder
    import packnet_sfm_tpu_torch.engine

    monkeypatch.delattr(packnet_sfm_tpu_torch.engine, "spans")
    monkeypatch.setitem(sys.modules, "packnet_sfm_tpu_torch.engine.spans", None)
    run = Run(FakeCell(), 10, 1.0, 0.5, 1e15)
    assert _read("batch_copy_host_ms.eval", run, None) is None
    assert run.cell.calls == []
