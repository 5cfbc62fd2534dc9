"""The least time of the port's soft-argmax kernels (``csrc/softargmax.cu``:
K6f ``softargmax_fwd_kernel`` and K6b ``softargmax_bwd_kernel``) from
shapes, as the program's PERF.md counts them: B images of direction and ray
fields [B, 3, h, w], a window of k = 2 p + 1 squared around each pixel.

- Forward: every window position takes 15 FP32 operations (a 3-term dot,
  the 1/T scale, the running max and exp, the sum and both coordinates'
  updates) and one exponential on the special-function units (16 lanes a
  clock on each of 132 SMs, at the largest SM clock, 1980 MHz); bytes: the
  two fields read and ex, ey, m, s written, 40 B a pixel.
- Backward: 12 FP32 operations a position (the dot, the scale, exp(logit -
  m) replayed, the weight), the accumulations of d direction and d rays
  left out (a lower bound); bytes: both fields, ex, ey, m, s, both
  coordinate gradients read, both field gradients written, 72 B a pixel.

A launch's least time is the largest of its operations at the float32 peak,
its exponentials on the SFUs, its bytes at the card's bandwidth and the
launch floor.
"""

from __future__ import annotations

from portbench import yardstick

FWD_OPS, BWD_OPS = 15, 12
SM_COUNT, SFU_LANES, SM_CLOCK_HZ = 132, 16, 1.98e9
FWD_BYTES, BWD_BYTES = (2 * 3 + 4) * 4, (2 * 3 + 6 + 2 * 3) * 4


def positions(batch: int, h: int, w: int, patch: int) -> int:
    return batch * h * w * (2 * patch + 1) ** 2


def fwd_s(batch: int, h: int, w: int, patch: int) -> float:
    n = positions(batch, h, w, patch)
    return max(FWD_OPS * n / yardstick.PEAK_FLOPS["float32"],
               n / (SM_COUNT * SFU_LANES * SM_CLOCK_HZ),
               FWD_BYTES * batch * h * w / yardstick.HBM_BYTES_PER_S, yardstick.LAUNCH_FLOOR_S)


def bwd_s(batch: int, h: int, w: int, patch: int) -> float:
    n = positions(batch, h, w, patch)
    return max(BWD_OPS * n / yardstick.PEAK_FLOPS["float32"],
               BWD_BYTES * batch * h * w / yardstick.HBM_BYTES_PER_S, yardstick.LAUNCH_FLOOR_S)


def step_launches(batch: int, height: int, width: int, contexts: int, patch: int):
    """The soft-argmax launches of one NRS train step: a forward and a
    backward a context, at half resolution -> [(kernel, least seconds)],
    kernel 'softargmax_fwd' or 'softargmax_bwd'."""
    h, w = height // 2, width // 2
    return [(k, s) for _ in range(contexts)
            for k, s in (("softargmax_fwd", fwd_s(batch, h, w, patch)),
                         ("softargmax_bwd", bwd_s(batch, h, w, patch)))]
