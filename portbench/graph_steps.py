"""The share of the recorded window's steps (``portbench/spans.py``) that
replayed the program's captured CUDA graph: each step record's counter
``graph_replays`` (``packnet_sfm_tpu_torch.engine.spans``), 1 for a
replayed step and 0 for an eager one. A program whose records have no such
counter gives None: the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench import spans


def share(records: list) -> Optional[float]:
    """% of ``records`` with a replay; None where any lacks the counter."""
    counts = [r.counters.get("graph_replays") for r in records]
    if not counts or None in counts:
        return None
    return 100.0 * sum(c > 0 for c in counts) / len(counts)


def step_pct(run) -> Optional[float]:
    window = spans.recorded(run)
    return share(window.records) if window is not None else None
