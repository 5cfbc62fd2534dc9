"""The traced window, reduced: device operations from torch.profiler's trace
(CUPTI), attributed to kernel groups and to the program's profiler ranges,
the union of their intervals (the device's busy time), the idle gaps
between them named by what the host was doing, and the breakdown that the
result line carries.

Per-layer metric readers (``portbench/metrics/``) read a ``Trace``; its
numbers are sums over the traced steps unless a name says otherwise.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import yardstick

# ranges that the program opens (models/sfm.py, engine/train.py; torch's
# optimizer) and the benchmark's own span around each step call
REGIONS = ("depth_net", "sparse_branch", "pose_net", "photometric_loss", "supervised_loss",
           "depth_metrics")
STEP_SPAN = "portbench.step"


def _is_device(evt) -> bool:
    import torch

    return evt.device_type == torch.autograd.DeviceType.CUDA


def _region_of(evt) -> Optional[str]:
    while evt is not None:
        if evt.name in REGIONS:
            return evt.name
        if evt.name.startswith("Optimizer.step"):
            return "optimizer"
        evt = evt.cpu_parent
    return None


def _conv_rank(evt) -> Optional[int]:
    if evt.name not in yardstick.CONV_OPS:
        return None
    shapes = getattr(evt, "input_shapes", None) or []
    return len(shapes[0]) if shapes and shapes[0] else None


def union_length(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(length of the union of [start, end) intervals, the merged intervals)."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class Trace:
    """A traced window of ``steps`` steps that took ``window_s`` seconds by
    the host's clock, from its first step call to the synchronize after its
    last. Built from a list of ``FunctionEvent`` (``profile.events()``), or
    from plain records in the tests (``from_records``)."""

    def __init__(self, steps: int, window_s: float):
        self.steps, self.window_s = steps, window_s
        self.device_ops: List[Tuple[str, float, float]] = []    # (name, start us, end us)
        self.groups: Dict[str, float] = defaultdict(float)     # group -> device us
        self.regions: Dict[str, float] = defaultdict(float)    # range -> device us
        self.host_ranges: Dict[str, float] = defaultdict(float)  # range -> host us
        self.host_ops: List[Tuple[str, float, float, int]] = []  # (name, start, end, depth)
        self.gaps_named: Optional["Trace"] = None   # the trace whose gaps carry host names

    @classmethod
    def from_events(cls, events, steps: int, window_s: float) -> "Trace":
        t = cls(steps, window_s)
        for evt in events:
            if _is_device(evt):
                if getattr(evt, "is_user_annotation", False) or evt.name.startswith(
                        "Optimizer.") or evt.name in REGIONS or evt.name == STEP_SPAN:
                    continue    # a range mirrored on the device timeline, not an operation
                t.device_ops.append((evt.name, evt.time_range.start, evt.time_range.end))
                continue
            depth, p = 0, evt.cpu_parent
            while p is not None:
                depth, p = depth + 1, p.cpu_parent
            t.host_ops.append((evt.name, evt.time_range.start, evt.time_range.end, depth))
            if evt.name in REGIONS:
                t.host_ranges[evt.name] += evt.time_range.end - evt.time_range.start
            if not evt.kernels:
                continue
            rank, region = _conv_rank(evt), _region_of(evt)
            for k in evt.kernels:
                t.groups[yardstick.group_of(k.name, rank)] += k.duration
                if region is not None:
                    t.regions[region] += k.duration
        return t

    @classmethod
    def from_records(cls, steps: int, window_s: float, device_ops, groups=None, regions=None,
                     host_ops=(), host_ranges=None) -> "Trace":
        t = cls(steps, window_s)
        t.device_ops = list(device_ops)
        t.groups.update(groups or {})
        t.regions.update(regions or {})
        t.host_ops = list(host_ops)
        t.host_ranges.update(host_ranges or {})
        return t

    def with_attribution(self, other: "Trace") -> "Trace":
        """This trace's device timeline, with the groups, ranges, host
        operators and host ranges of ``other`` (a trace of as many steps
        that also recorded the host)."""
        self.groups, self.regions = other.groups, other.regions
        self.host_ranges = other.host_ranges
        self.gaps_named = other
        return self

    # ---- what the metric readers read --------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return union_length([(s, e) for _, s, e in self.device_ops])[0] / 1e6

    def group_ms_per_step(self, group: str) -> Optional[float]:
        us = self.groups.get(group, 0.0)
        return us / 1e3 / self.steps if us > 0 else None

    def region_ms_per_step(self, *regions: str) -> Optional[float]:
        us = sum(self.regions.get(r, 0.0) for r in regions)
        return us / 1e3 / self.steps if us > 0 else None

    def host_range_ms_per_step(self, region: str) -> Optional[float]:
        us = self.host_ranges.get(region, 0.0)
        return us / 1e3 / self.steps if us > 0 else None

    def ops_named(self, *fragments: str) -> List[Tuple[str, float]]:
        """(name, seconds) of each device operation whose name holds one of
        ``fragments``, in the trace's order."""
        return [(n, (e - s) / 1e6) for n, s, e in sorted(self.device_ops, key=lambda o: o[1])
                if any(f in n for f in fragments)]

    # ---- the breakdown -----------------------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the longest idle gaps between operations, each named by the host's
        deepest range or operator open at the gap's middle (from the trace
        that recorded the host, where this one did not)."""
        by_name: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device_ops:
            by_name[n[:120]] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        named = self.gaps_named or self
        _, merged = union_length([(s, e) for _, s, e in named.device_ops])
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                       for i in range(len(merged) - 1)), reverse=True)[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[named.host_at(t0 + g / 2), g / 1e6] for g, t0 in gaps]}

    def host_at(self, t: float) -> str:
        """The deepest host operator open at time ``t`` (us), after the
        deepest range open around it: 'range/operator'."""
        open_ops = sorted((d, n) for n, s, e, d in self.host_ops if s <= t < e)
        if not open_ops:
            return "host idle"
        ranges = [n for _, n in open_ops
                  if n in REGIONS or n == STEP_SPAN or n.startswith("Optimizer.")]
        inner = open_ops[-1][1]
        return inner if not ranges or ranges[-1] == inner else f"{ranges[-1]}/{inner}"
