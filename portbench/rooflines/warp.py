"""Bytes and the least time of the port's bilinear warp kernels
(``csrc/warp.cu``: ``warp_fwd`` and ``warp_bwd``, float32 or bfloat16
image), counted from shapes: each input byte read once and each output
byte written once.

Forward, a pixel of the output: its two float32 coordinates (8 B), its C
float32 outputs, and C image values of the image's itemsize (an image
pixel a sampled pixel, the image being the output's size on every path
that the benchmark runs). Backward (d coords only): the coordinates, the C
float32 output gradients, the C image values, the two float32 coordinate
gradients. Float32 image, C = 3: 32 B and 40 B a pixel; bfloat16: 26 B
and 34 B, as the program's PERF.md derives them.
"""

from __future__ import annotations

from portbench import yardstick


def fwd_bytes(pixels: int, channels: int, image_itemsize: int) -> int:
    return pixels * (8 + 4 * channels + image_itemsize * channels)


def bwd_bytes(pixels: int, channels: int, image_itemsize: int) -> int:
    return pixels * (8 + 4 * channels + image_itemsize * channels + 8)


def bound_s(nbytes: int) -> float:
    """The least time of one launch: its bytes at the card's bandwidth, or
    the launch floor, whichever is larger."""
    return max(nbytes / yardstick.HBM_BYTES_PER_S, yardstick.LAUNCH_FLOOR_S)


def step_launches(batch: int, height: int, width: int, contexts: int, scales: int,
                  image_itemsize: int, channels: int = 3):
    """The warp launches of one self-supervised train step: at each scale
    one forward and one backward over the contexts stacked on the batch
    axis -> [(kernel, least seconds)], kernel 'warp_fwd' or 'warp_bwd'."""
    out = []
    for s in range(scales):
        pixels = contexts * batch * (height >> s) * (width >> s)
        out.append(("warp_fwd", bound_s(fwd_bytes(pixels, channels, image_itemsize))))
        out.append(("warp_bwd", bound_s(bwd_bytes(pixels, channels, image_itemsize))))
    return out
