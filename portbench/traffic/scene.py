"""Synthetic driving-like frames for the benchmark's traffic, made in bulk
on the run's device from a seed and handed over as host arrays: a
multi-octave value-noise texture of its own contrast and brightness for
each sample, a smooth depth of its own range and phase, and context frames
rendered by warping the texture through that depth under a lateral camera
shift, so that the photometric loss has a true minimum. The samples of a
batch differ as a real batch's scenes do; in a train batch their contrasts
are spread evenly over the range, lowest first, so that a step that sees
only part of its batch shows in its loss on every seed. Frames
leave as uint8 NHWC numpy arrays, the form the loader hands the train and
eval steps. (After the synthetic dataset of the program's
``datasets/synthetic.py``.)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def rand(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def textures(gen: torch.Generator, n: int, h: int, w: int, ordered: bool = False) -> torch.Tensor:
    """n value-noise textures in [0, 1], [n, 3, H, W] float32, each with its
    own contrast (0.2 to 1 of the full range) and mean (0.3 to 0.7). With
    ``ordered`` sample i's contrast is drawn from the i-th of n equal parts
    of that range (for n = 1 the same draw as without)."""
    img = torch.zeros(n, 3, h, w, device=gen.device)
    for cell, amp in ((16, 0.45), (8, 0.3), (4, 0.15), (2, 0.1)):
        grid = rand(gen, n, 3, h // cell + 2, w // cell + 2)
        img += amp * F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False)
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    img = (img - lo) / (hi - lo).clamp(min=1e-6) - 0.5
    u = rand(gen, n, 1, 1, 1)
    if ordered:
        u = (torch.arange(n, device=gen.device).view(n, 1, 1, 1) + u) / n
    contrast = 0.2 + 0.8 * u
    mean = 0.3 + 0.4 * rand(gen, n, 1, 1, 1)
    return (mean + contrast * img).clamp(0.0, 1.0)


def depth_maps(gen: torch.Generator, n: int, h: int, w: int, near=(3.0, 8.0),
               span=(5.0, 20.0)) -> torch.Tensor:
    """n smooth depths [n, H, W]: each between its own near (drawn from
    ``near``) and near + its own span (drawn from ``span``) m, with its own
    phase."""
    ys, xs = torch.meshgrid(torch.arange(h, device=gen.device, dtype=torch.float32),
                            torch.arange(w, device=gen.device, dtype=torch.float32), indexing="ij")
    lo = near[0] + (near[1] - near[0]) * rand(gen, n, 1, 1)
    size = span[0] + (span[1] - span[0]) * rand(gen, n, 1, 1)
    phase = 6.2832 * rand(gen, n, 1, 1)
    return lo + size * (0.5 + 0.5 * torch.sin(xs / w * 3 + ys / h * 2 + phase))


def intrinsics(n: int, h: int, w: int) -> np.ndarray:
    """KITTI-like pinhole intrinsics (fx = fy = 0.58 W, centred), [n, 3, 3]."""
    f = 0.58 * w
    K = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]], np.float32)
    return np.repeat(K[None], n, axis=0)


def _uint8_nhwc(img: torch.Tensor) -> np.ndarray:
    return (img * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def frames(gen: torch.Generator, n: int, h: int, w: int, contexts: int,
           ordered: bool = False):
    """(target [n, H, W, 3], [context [n, H, W, 3]] * contexts), uint8:
    each context the target's texture seen from a camera shifted by 0.6 to
    1.2 m to the left (first half) or the right; ``ordered`` as
    ``textures``."""
    tex = textures(gen, n, h, w, ordered)
    depth = depth_maps(gen, n, h, w)
    ys, xs = torch.meshgrid(torch.arange(h, device=gen.device, dtype=torch.float32),
                            torch.arange(w, device=gen.device, dtype=torch.float32), indexing="ij")
    f = 0.58 * w
    ctx = []
    for c in range(contexts):
        sign = -1.0 if c < contexts // 2 else 1.0
        tx = sign * 0.3 * torch.floor(2 + 3 * rand(gen, n))
        u = xs[None] - f * tx[:, None, None] / depth
        grid = torch.stack([2 * u / (w - 1) - 1, (2 * ys / (h - 1) - 1).expand_as(u)], -1)
        ctx.append(_uint8_nhwc(F.grid_sample(tex, grid, padding_mode="border",
                                              align_corners=True)))
    return _uint8_nhwc(tex), ctx


def sparse_depth(gen: torch.Generator, n: int, h: int, w: int, density: float,
                 near=(3.0, 8.0), span=(5.0, 20.0)) -> torch.Tensor:
    """[n, H, W, 1] float32 depth (``depth_maps``) on a random ``density``
    share of the pixels, 0 elsewhere (on the generator's device)."""
    keep = rand(gen, n, h, w) < density
    return (depth_maps(gen, n, h, w, near, span) * keep)[..., None]


def jitter_factors(gen: torch.Generator, n: int, ranges) -> np.ndarray:
    """Per-sample colour jitter factors [n, 4] (brightness, contrast,
    saturation in [max(0, 1 - v), 1 + v], hue shift in [-v, v])."""
    bv, cv, sv, hv = ranges
    lo = torch.tensor([max(0.0, 1 - bv), max(0.0, 1 - cv), max(0.0, 1 - sv), -hv])
    hi = torch.tensor([1 + bv, 1 + cv, 1 + sv, hv])
    return (lo + (hi - lo) * rand(gen, n, 4).cpu()).numpy().astype(np.float32)
