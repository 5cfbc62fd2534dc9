"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; CUDA is the default.

    Raises when CUDA is asked for and there is none, or when ``cuda:N``
    names a card that is not there: the port never falls back to the CPU
    or to another card on its own. Pass ``device="cpu"`` to run there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no card {dev}: this machine has {torch.cuda.device_count()}")
    return dev
