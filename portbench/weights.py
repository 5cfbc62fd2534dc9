"""Weights made by the benchmark from the seed, in one draw on the run's
device, and handed alike to the program and to the reference: every
convolution kernel (a parameter of two or more dimensions) xavier-uniform,
every bias 0 and every other parameter (norm scales, PackNet-SAN's skip
weights) 1, as the program's own initializers set them. Leaves are
taken in the order of their sorted names, so that two models with the same
parameter names get the same values whatever order they hold them in.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _bound(shape) -> float:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return math.sqrt(6.0 / (shape[1] * receptive + shape[0] * receptive))


def draw(named: Iterable[Tuple[str, torch.Tensor]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: values} for every parameter among ``named`` (name, parameter)."""
    named = list(named)
    kernels = sorted((n, tuple(p.shape)) for n, p in named if p.dim() >= 2)
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(_bound(shape))
        at += n
    for name, p in named:
        if p.dim() < 2:
            fill = 0.0 if name.split(".")[-1] == "bias" else 1.0
            out[name] = torch.full(p.shape, fill, device=device)
    return out


@torch.no_grad()
def load(module: torch.nn.Module, seed: int) -> None:
    """Set ``module``'s parameters to the draw of ``seed`` over all of them."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    drawn = draw(params.items(), seed, device)
    for name, p in params.items():
        p.copy_(drawn[name])
