"""One run of one cell: find the cell's files by name, set it up, measure
it for a fixed window, read the per-layer metrics from a traced window if
asked, check its outputs against the reference, and give the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (its recipes as the program
  reads them, published sizes, assumptions, the peaks ``mfu`` divides by);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  batch maker ``traffic/<kind>.py`` and the program side ``kinds/<kind>.py``;
- ``cells/<workload>.json``: the recipe the cell runs, its TF32 flags, its
  precision, its traced steps and the limits of its check;
- ``metrics/<metric>.py``: a reader, ``read(run, trace)`` -> a number or
  None (nothing to read: the metric is left out of the line); an end-to-end
  metric other than the five below reads ``run`` alone (``trace`` None).

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; none of the files here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PACKAGE = Path(__file__).resolve().parent


class Registry:
    """The benchmark's files: ``BENCHMARK.json`` and the directories
    searched, in order, for a name's file (the package's own last)."""

    def __init__(self, benchmark: Path, extra_dirs: List[Path] = ()):
        self.spec = json.loads(Path(benchmark).read_text())
        self.dirs = [Path(d) for d in extra_dirs] + [PACKAGE]

    def find(self, sub: str, name: str) -> Path:
        for d in self.dirs:
            p = d / sub / name
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name} in {', '.join(map(str, self.dirs))}")

    def data(self, sub: str, name: str) -> dict:
        return json.loads(self.find(sub, name + ".json").read_text())

    def code(self, sub: str, name: str):
        path = self.find(sub, name + ".py")
        spec = importlib.util.spec_from_file_location(f"portbench_{sub}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name} in BENCHMARK.json")

    def metrics_of(self, workload: str, group: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[group]
                if "workloads" not in m or workload in m["workloads"]]


class Run:
    """What a window measured, for the metric readers."""

    def __init__(self, cell, steps: int, window_s: float, host_s: float, peak_flops: float):
        self.cell = cell                    # the kind's object (kinds/<kind>.py)
        self.steps, self.window_s = steps, window_s
        self.host_ms_per_step = host_s / steps * 1e3
        self.images = steps * cell.images_per_step()
        self.peak_flops = peak_flops
        self._flops = None

    def flops_per_step(self) -> float:
        if self._flops is None:
            self._flops = self.cell.flops_per_step()
        return self._flops


def window(cell, seconds: float, first: int, device) -> tuple:
    """Steps dispatched back to back for ``seconds`` by the host's clock (and
    at least the ``min_steps`` the cell's check samples from), with no
    synchronize between them, then one: (steps, window seconds, host seconds
    spent inside the step calls)."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    steps, host = 0, 0.0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        cell.step(first + steps)
        b = time.perf_counter()
        host += b - a
        steps += 1
        if b - t0 >= seconds and steps >= cell.min_steps:
            break
    sync()
    return steps, time.perf_counter() - t0, host


def traced_window(cell, steps: int, first: int, device):
    """Two traced windows of ``steps`` steps each, each step inside the range
    'portbench.step' -> Trace. The first traces the device alone (CUPTI,
    which costs the host little): the busy time, the window's length and
    the device operations come from it. The second also traces the host's
    operators with their input shapes, which slows a host-paced step
    several times over: the kernels' groups and ranges, the host ranges'
    times and the names of the idle gaps come from it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import STEP_SPAN, Trace

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]

    def traced(activities, start, shapes):
        with profile(activities=activities, record_shapes=shapes) as prof:
            sync()
            t0 = time.perf_counter()
            for i in range(steps):
                with record_function(STEP_SPAN):
                    cell.step(start + i)
            sync()
            window_s = time.perf_counter() - t0
        return Trace.from_events(prof.events(), steps, window_s)

    timeline = traced(device_only, first, False)
    attributed = traced([ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                        first + steps, True)
    return timeline.with_attribution(attributed)


def run_cell(registry: Registry, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, fault: Optional[str] = None,
             clock_start: Optional[float] = None) -> Dict:
    """One run; returns the result's fields, with 'checks' {name: (value,
    limit)} and 'correct'. ``device`` is the card (the caller has checked
    it), or the CPU in the tests (whose trace holds no device operation)."""
    t_setup = clock_start if clock_start is not None else time.perf_counter()
    w = registry.workload(workload)
    config = registry.data("configs", w["config"])
    traffic = registry.data("traffic", w["traffic"])
    cell_spec = registry.data("cells", workload)
    kind = registry.code("kinds", traffic["kind"])
    make_pool = registry.code("traffic", traffic["kind"]).make_pool

    tf32 = cell_spec["tf32"]
    torch.backends.cudnn.allow_tf32 = tf32["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell = kind.build(config, traffic, cell_spec, seed, device, make_pool, fault)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup

    steps, window_s, host_s = window(cell, seconds, len(cell.pool), device)
    peak_bytes = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    peak_flops = config["peaks_flops"][cell_spec["precision"]]
    run = Run(cell, steps, window_s, host_s, peak_flops)
    out = {"steps": steps, "window_s": window_s, "setup_s": setup_s,
           "memory_peak_bytes": peak_bytes}

    metrics = {}
    if trace:
        tr = traced_window(cell, cell_spec["trace_steps"], len(cell.pool) + steps, device)
        out["busy_s"], out["trace_window_s"] = tr.busy_s(), tr.window_s
        out["breakdown"] = tr.breakdown()
        for m in registry.metrics_of(workload, "per_layer"):
            value = registry.code("metrics", m["name"]).read(run, tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = run.images / window_s
        values = {"setup_s": setup_s, "peak_mem_mib": peak_bytes / 2 ** 20,
                  "train_images_per_s": rate, "host_paced_train_images_per_s": rate,
                  "eval_images_per_s": rate}
        for m in registry.metrics_of(workload, "end_to_end"):
            value = (values[m["name"]] if m["name"] in values
                     else registry.code("metrics", m["name"]).read(run, None))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics

    # the check: the program's state freed, then the reference
    got = cell.readings()
    cell.free()
    readings = cell.compare(got, cell.reference())
    limits = cell_spec["limits"]
    out["checks"] = {k: (readings[k], limits[k]) for k in limits}
    out["correct"] = all(v <= lim for v, lim in out["checks"].values())
    return out
