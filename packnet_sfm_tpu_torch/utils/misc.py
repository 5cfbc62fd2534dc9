"""Small helpers: the port's own copies of ``make_list``, ``filter_dict``,
``same_shape`` and ``parse_crop_borders`` from
``packnet_sfm_tpu/utils/misc.py`` (same results for the same arguments)."""

from __future__ import annotations

from typing import Any, Sequence


def make_list(x: Any, n: int | None = None) -> list:
    """``x`` as a list, broadcast to length ``n`` where given: a list or
    tuple passes through (one element is repeated ``n`` times, another
    length than ``n`` raises); anything else is repeated ``n`` times (once
    without ``n``)."""
    if isinstance(x, (list, tuple)):
        x = list(x)
        if n is not None and len(x) == 1:
            return x * n
        if n is not None and len(x) != n:
            raise ValueError(f"list length {len(x)} != requested {n}")
        return x
    return [x] * (n if n is not None else 1)


def filter_dict(d: dict, keys: Sequence[str]) -> list:
    """The subset of ``keys`` present in ``d``."""
    return [k for k in keys if k in d]


def same_shape(a: Sequence[int], b: Sequence[int]) -> bool:
    """True if two shapes have the same length and entries."""
    return len(a) == len(b) and all(x == y for x, y in zip(a, b))


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
