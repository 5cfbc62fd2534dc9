"""Small helpers: the port's own copies of ``filter_dict`` and
``parse_crop_borders`` from ``packnet_sfm_tpu/utils/misc.py`` (same results
for the same arguments)."""

from __future__ import annotations

from typing import Sequence


def filter_dict(d: dict, keys: Sequence[str]) -> list:
    """The subset of ``keys`` present in ``d``."""
    return [k for k in keys if k in d]


def parse_crop_borders(borders: Sequence, shape: Sequence[int]) -> tuple:
    """Resolve crop borders into absolute pixel coords ``(x1, y1, x2, y2)``.

    - empty -> full image
    - len 2 -> (w, h) centered crop; floats are relative, negatives subtract
    - len 4 -> (x1, y1, x2, y2); floats relative, non-positive values wrap
      from the far edge.
    ``shape`` is (H, W).
    """
    h, w = shape[-2], shape[-1]
    if len(borders) == 0:
        return (0, 0, w, h)

    def _abs(v, size):
        return int(v * size) if isinstance(v, float) else int(v)

    if len(borders) == 2:
        cw, ch = _abs(borders[0], w), _abs(borders[1], h)
        if cw <= 0:
            cw += w
        if ch <= 0:
            ch += h
        x1, y1 = (w - cw) // 2, (h - ch) // 2
        return (x1, y1, x1 + cw, y1 + ch)
    if len(borders) == 4:
        x1, y1, x2, y2 = (_abs(borders[0], w), _abs(borders[1], h),
                          _abs(borders[2], w), _abs(borders[3], h))
        if x2 <= 0:
            x2 += w
        if y2 <= 0:
            y2 += h
        return (x1, y1, x2, y2)
    raise ValueError(f"Invalid crop borders {borders}")
