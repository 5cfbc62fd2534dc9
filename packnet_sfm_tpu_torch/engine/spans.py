"""Spans at the boundaries of the train and eval steps, and the counters of
each step.

``span(name)`` always opens ``torch.profiler.record_function(name)``, so in
a ``torch.profiler`` trace (``cli.train --profile-dir``, the benchmark's
traced window) it sits on the same clock as the device's operations. Inside
``recording()`` it also keeps the span's name, its parent and its host start
and end (``time.perf_counter_ns``) in the record of the current step.
``step_span(name)`` is the root span of one step: it opens a new record,
which all the spans of the step share, and at its end stores the step's
counters: the change over the step of the kernels' launch counters
(``ops/warp.launch_counts``, ``bf16_launch_counts``,
``ops/softargmax.launch_counts``, ``band_launch_counts``,
``ops/fold_conv.launch_counts``, which stay the one store of those counts;
a replayed CUDA graph adds its launches there, ``add_launches``), the host
arrays the step moved to its device (``note_copy``): their bytes, their
number, and how many came from pageable host memory, whose copy to a card
waits for the stream; and ``graph_replays``, 1 where the step replayed a
captured CUDA graph (``note_replay``), 0 where it ran eagerly.

Off, the default, a span costs its ``record_function`` and one check. Only
the thread that opened the step records (the autograd engine's threads run
the backward on a card); records stay in memory and are the list that
``recording()`` yields. ``summary`` reduces them to each span's mean host
ms a step and its self time (less its children's).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from torch.profiler import record_function


@dataclasses.dataclass
class Span:
    name: str
    parent: int             # index of the parent in the record's spans; -1 for the root
    start_ns: int
    end_ns: int = 0


@dataclasses.dataclass
class StepRecord:
    step: int               # the id that the step's spans share
    spans: List[Span]
    counters: Dict[str, int]


class _Recorder:
    def __init__(self):
        self.records: List[StepRecord] = []
        self.current: Optional[StepRecord] = None
        self.thread = None
        self.open: List[int] = []
        self.launches_at_start: Dict[str, int] = {}

    def recording_here(self) -> bool:
        return self.current is not None and threading.get_ident() == self.thread

    def enter(self, name: str) -> int:
        spans = self.current.spans
        spans.append(Span(name, self.open[-1], time.perf_counter_ns()))
        self.open.append(len(spans) - 1)
        return self.open[-1]

    def exit(self, index: int) -> None:
        self.current.spans[index].end_ns = time.perf_counter_ns()
        self.open.pop()


_recorder: Optional[_Recorder] = None


def _counter_dicts() -> tuple:
    from packnet_sfm_tpu_torch.ops import fold_conv, softargmax, warp

    return (warp.launch_counts, warp.bf16_launch_counts, softargmax.launch_counts,
            softargmax.band_launch_counts, fold_conv.launch_counts)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by kernel name."""
    return {k: v for counts in _counter_dicts() for k, v in counts.items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` ({kernel: launches}) to the kernels' launch counters:
    the launches of a replayed CUDA graph, which no wrapper counts."""
    for counts in _counter_dicts():
        for k in counts:
            counts[k] += delta.get(k, 0)


@contextlib.contextmanager
def recording():
    """Turn the recorder on; yields the list of ``StepRecord``, one a step
    run inside, complete when the block exits."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the span recorder is already on")
    rec = _recorder = _Recorder()
    try:
        yield rec.records
    finally:
        _recorder = None


@contextlib.contextmanager
def span(name: str):
    """A profiler range, and a span of the current step's record while
    recording."""
    with record_function(name):
        rec = _recorder
        if rec is None or not rec.recording_here():
            yield
            return
        index = rec.enter(name)
        try:
            yield
        finally:
            rec.exit(index)


@contextlib.contextmanager
def step_span(name: str):
    """The root span of one step: a new record while recording (a plain
    ``span`` inside another step)."""
    rec = _recorder
    if rec is None or rec.current is not None:
        with span(name):
            yield
        return
    with record_function(name):
        rec.thread = threading.get_ident()
        rec.launches_at_start = launch_counts()
        rec.current = StepRecord(len(rec.records), [Span(name, -1, time.perf_counter_ns())],
                                 {"copy_bytes": 0, "copies": 0, "pageable_copies": 0,
                                  "graph_replays": 0})
        rec.open = [0]
        try:
            yield
        finally:
            record, rec.current = rec.current, None
            record.spans[0].end_ns = time.perf_counter_ns()
            record.counters.update({k: v - rec.launches_at_start.get(k, 0)
                                    for k, v in launch_counts().items()})
            rec.records.append(record)


def note_copy(host) -> None:
    """Count one host tensor moved to the step's device (``engine/train.
    to_device_float``) in the current step's record, if recording."""
    rec = _recorder
    if rec is not None and rec.recording_here():
        counters = rec.current.counters
        counters["copy_bytes"] += host.nbytes
        counters["copies"] += 1
        counters["pageable_copies"] += not host.is_pinned()


def note_replay() -> None:
    """Count one replay of a captured CUDA graph in the current step's
    record, if recording."""
    rec = _recorder
    if rec is not None and rec.recording_here():
        rec.current.counters["graph_replays"] += 1


def summary(records: List[StepRecord]) -> dict:
    """{'steps': n, 'spans': {name: {'ms', 'self_ms', 'calls'}}, 'counters':
    {name: count}}: each span's host ms, its self ms (its time less its
    children's) and its calls, and each counter, as means over the steps."""
    sums: Dict[str, List[int]] = {}         # name -> [ns, self ns, calls]
    counters: Dict[str, int] = {}
    for record in records:
        own = [s.end_ns - s.start_ns for s in record.spans]
        self_ns = list(own)
        for s, ns in zip(record.spans, own):
            if s.parent >= 0:
                self_ns[s.parent] -= ns
        for s, ns, self_ in zip(record.spans, own, self_ns):
            row = sums.setdefault(s.name, [0, 0, 0])
            row[0] += ns
            row[1] += self_
            row[2] += 1
        for k, v in record.counters.items():
            counters[k] = counters.get(k, 0) + v
    n = len(records)
    return {"steps": n,
            "spans": {name: {"ms": ns / 1e6 / n, "self_ms": self_ / 1e6 / n, "calls": calls / n}
                      for name, (ns, self_, calls) in sums.items()},
            "counters": {k: v / n for k, v in counters.items()}}
