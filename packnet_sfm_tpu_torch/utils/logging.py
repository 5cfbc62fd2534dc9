"""Console logging helpers: the port's own copy of ``pcolor``, ``AvgMeter``
and ``print_config`` from ``packnet_sfm_tpu/utils/logging.py``."""

from __future__ import annotations

from collections import deque


def pcolor(text: str, color: str = "cyan", attrs=None) -> str:
    """ANSI-colored text."""
    codes = {"red": 31, "green": 32, "yellow": 33, "blue": 34,
             "magenta": 35, "cyan": 36, "white": 37}
    attr_codes = {"bold": 1, "dark": 2, "underline": 4}
    seq = [str(codes.get(color, 36))]
    for a in (attrs or []):
        seq.append(str(attr_codes.get(a, 0)))
    return f"\033[{';'.join(seq)}m{text}\033[0m"


class AvgMeter:
    """The average of the last ``n_max`` values given."""

    def __init__(self, n_max: int = 100):
        self.values = deque(maxlen=n_max)

    def __call__(self, value: float) -> float:
        self.values.append(float(value))
        return self.get()

    def get(self) -> float:
        return sum(self.values) / max(len(self.values), 1)

    def reset(self):
        self.values.clear()

    def get_and_reset(self) -> float:
        v = self.get()
        self.reset()
        return v


def print_config(config, prefix: str = "config") -> None:
    """Colored recursive config dump."""
    from packnet_sfm_tpu_torch.core.config import ConfigNode

    def walk(node, depth=0):
        pad = "    " * depth
        for k, v in node.items():
            if isinstance(v, ConfigNode):
                print(pcolor(f"{pad}{k}:", "yellow", ["bold"]))
                walk(v, depth + 1)
            else:
                print(pcolor(f"{pad}{k}:", "cyan") + f" {v}")

    print(pcolor("#" * 60, "red", ["bold"]))
    print(pcolor(f"### {prefix}", "red", ["bold"]))
    print(pcolor("#" * 60, "red", ["bold"]))
    walk(config)
