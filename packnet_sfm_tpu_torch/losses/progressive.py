"""Progressive scale-count schedule (port of ``losses/progressive.py``).

Host side: the trainer resolves the scale count before it builds the step.
"""

from __future__ import annotations

import bisect


def progressive_num_scales(progress: float, num_scales: int, progressive_scaling: float) -> int:
    """Scale count in effect at training ``progress`` in [0, 1].

    Thresholds are ``[ps*(i+1) for i in range(n-1)] + [1.0]`` and the count
    is ``n - searchsorted(thresholds, progress)``; disabled when ps <= 0.
    """
    if progressive_scaling <= 0.0:
        return num_scales
    thresholds = [progressive_scaling * (i + 1) for i in range(num_scales - 1)] + [1.0]
    return int(num_scales - bisect.bisect_left(thresholds, progress))
