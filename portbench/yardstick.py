"""The benchmark's fixed arithmetic: the card's published peaks, the kernel
groups of a device trace, and the comparisons of per-leaf norms that decide
``correct``. Later changes to the program cannot move any of it.

The kernel groups are those of the program's ``tools/profile_step.py``
(copied): convolution kernels are told 2D from 3D by the rank of the
operator that launched them, every other kernel by the first fragment of
its name that matches.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# the shortest a kernel launch takes on the card: an empty kernel's time,
# measured by the program's chip_smoke.py (0.0018 ms)
LAUNCH_FLOOR_S = 1.8e-6

GROUPS = (
    ("softargmax", "softargmax"),
    ("Sort", "sort"), ("sort", "sort"),
    ("warp_fwd_kernel", "warp"), ("warp_bwd_kernel", "warp"),
    ("conv", "conv2d"), ("gemm", "conv2d"), ("sm90_xmma", "conv2d"), ("cudnn", "conv2d"),
    ("dgrad", "conv2d"), ("wgrad", "conv2d"),
    ("batch_norm", "norm"), ("group_norm", "norm"), ("GroupNorm", "norm"),
    ("RowwiseMoments", "norm"), ("ComputeFusedParams", "norm"),
    ("avg_pool", "pool_pad"), ("reflection_pad", "pool_pad"),
    ("reduce", "reduction"),
    ("index", "gather"), ("gather", "gather"), ("scatter", "gather"),
    ("adam", "optimizer"), ("Adam", "optimizer"), ("multi_tensor", "optimizer"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("Memset", "copy"), ("Memcpy", "copy"), ("copy", "copy"),
)
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution_transpose", "aten::_convolution",
            "aten::convolution", "aten::conv2d", "aten::conv3d")


def group_of(kernel: str, conv_rank: Optional[int]) -> str:
    """The group of a kernel launched by an operator whose first input has
    rank ``conv_rank`` (None: not a convolution operator)."""
    if conv_rank in (4, 5) and "elementwise" not in kernel and "Memset" not in kernel:
        return "conv3d" if conv_rank == 5 else "conv2d"
    for fragment, group in GROUPS:
        if fragment in kernel:
            return group
    return "other"


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; over the leaves in ``keep`` (None: all). A leaf that the
    program lacks, or whose norm is not finite, reads infinite."""
    names = [n for n in reference if keep is None or n in keep]
    med = statistics.median(reference[n] for n in names)
    out = {}
    for n in names:
        p = program.get(n, float("nan"))
        out[n] = (abs(p - reference[n]) / max(reference[n], med, 1e-30)
                  if math.isfinite(p) else float("inf"))
    return out


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Optional[set] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(program, reference, keep).values())


def median_norm_gap(program: Dict[str, float], reference: Dict[str, float],
                    keep: Optional[set] = None) -> float:
    """The median leaf's gap (``leaf_gaps``): steady from seed to seed where
    the worst leaf's is the round-off of one small leaf."""
    return statistics.median(leaf_gaps(program, reference, keep).values())


def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> set:
    """The leaves whose reference gradient is not nought to rounding: above
    ``share`` of the median leaf's (a key's bias under softmax, or a bias
    before a norm, moves under Adam by round-off alone)."""
    med = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g > share * med}


def rel_gap(program: float, reference: float) -> float:
    if program != program:
        return float("inf")
    return abs(program - reference) / max(abs(reference), 1e-30)
