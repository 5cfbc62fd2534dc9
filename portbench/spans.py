"""The recorded window: the cell's steps driven back to back inside the
program's span recorder (``packnet_sfm_tpu_torch.engine.spans.recording``),
with no profiler on, for the per-layer metrics that read the program's
spans; and the device's idle gaps in a traced window counted by the
program's span the host was in.

The end-to-end metrics come from the measured window, with the recorder
off; this window's host times are not slowed by a profiler. It runs once a
run, the first time a reader asks (after the measured and the traced
windows), for as many steps as ``SECONDS`` hold at the measured window's
pace and at least ``MIN_STEPS``, then synchronizes; its result is kept on
the run. A program without the recorder, or a step that opens none of the
spans a reader asks for, gives None: the metric is left out of the line.
"""

from __future__ import annotations

import bisect
import math
import time
from typing import Optional

import torch

from portbench.trace import union_length

SECONDS = 5.0
MIN_STEPS = 3


class Recorded:
    """The recorded window: ``records`` (the program's ``StepRecord``, one a
    step) over ``window_s`` seconds, first step call to the synchronize
    after the last."""

    def __init__(self, records: list, window_s: float, summary: dict):
        self.records, self.window_s = records, window_s
        self.steps = len(records)
        self.summary = summary

    def host_ms(self, name: str) -> Optional[float]:
        """Mean host ms a step inside the program's span ``name``."""
        row = self.summary["spans"].get(name)
        return row["ms"] if row else None

    def ms_per_step(self) -> float:
        return self.window_s / self.steps * 1e3


def recorded(run) -> Optional[Recorded]:
    """The run's recorded window, run at the first call (None: the program
    has no span recorder)."""
    if not hasattr(run, "spans_window"):
        run.spans_window = _record(run)
    return run.spans_window


def _record(run) -> Optional[Recorded]:
    try:
        from packnet_sfm_tpu_torch.engine import spans
    except ImportError:
        return None
    cell = run.cell
    cuda = getattr(cell, "device", torch.device("cpu")).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    steps = max(MIN_STEPS, math.ceil(SECONDS / (run.window_s / run.steps)))
    first = len(cell.pool) + run.steps
    sync()
    t0 = time.perf_counter()
    with spans.recording() as records:
        for i in range(steps):
            cell.step(first + i)
        sync()
    window_s = time.perf_counter() - t0
    if not records:
        return None
    return Recorded(records, window_s, spans.summary(records))


def host_ms(run, name: str) -> Optional[float]:
    """Mean host ms a step of the recorded window inside the span ``name``."""
    window = recorded(run)
    return window.host_ms(name) if window is not None else None


def idle_ms_in(trace, names: tuple) -> Optional[float]:
    """Device idle ms a traced step in the gaps between the merged device
    operations of the host-and-device traced window (``gaps_named``) whose
    midpoint falls while the host is inside one of the program's spans
    ``names``. None where that trace holds no device operation, or none of
    those spans."""
    named = trace.gaps_named or trace
    _, inside = union_length([(s, e) for n, s, e, _ in named.host_ops if n in names])
    if not named.device_ops or not inside:
        return None
    starts = [s for s, _ in inside]
    _, merged = union_length([(s, e) for _, s, e in named.device_ops])
    total = 0.0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and inside[i][1] > mid:
            total += b - a
    return total / 1e3 / named.steps
