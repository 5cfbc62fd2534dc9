"""Differentiable bilinear warp sampling, NHWC (port of ``ops/warp.py``).

``out[b, i, j] = bilinear(image[b], coords[b, i, j])`` with coordinates
normalized to [-1, 1], align_corners=True (-1 -> pixel 0, +1 -> pixel S-1),
and padding 'zeros' (a tap outside the image counts as 0) or 'border' (a
tap's index is clamped into the image).

- ``grid_sample`` / ``grid_sample_data``: the entry points. On CUDA tensors
  their forward and backward are the hand-written kernels of
  ``csrc/warp.cu`` (the counterpart of the JAX package's four-tap row
  gather); on CPU tensors they are ``grid_sample_plain``. Any other device
  raises.
- ``grid_sample_plain``: plain PyTorch (floor, four index gathers, masks,
  lerp), differentiated by autograd. The CPU tests and ``chip_smoke.py``
  hold the kernels to it.
- ``launch_counts``: launches of each kernel, counted where the wrapper
  launches it, so a run can show that its path went through the kernels.

The kernels compute in float32. The gradient with respect to the
coordinates comes back in the coordinates' dtype.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

launch_counts = {"warp_fwd": 0, "warp_bwd": 0}

PADDING_MODES = {"zeros": 0, "border": 1}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def _padding_code(padding_mode: str) -> int:
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"padding_mode must be 'zeros' or 'border', got {padding_mode!r}")
    return PADDING_MODES[padding_mode]


def _check_shapes(image: torch.Tensor, coords: torch.Tensor) -> None:
    if image.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != image.shape[0]:
        raise ValueError(f"expected image [B,H,W,C] and coords [B,H',W',2], got "
                         f"{tuple(image.shape)} and {tuple(coords.shape)}")
    if min(image.shape[1:]) < 1:
        raise ValueError(f"image {tuple(image.shape)} has an empty dimension")


def warp_fwd_cuda(image: torch.Tensor, coords: torch.Tensor,
                  padding_mode: str = "zeros") -> torch.Tensor:
    """Forward kernel: image [B,H,W,C], coords [B,H',W',2] -> [B,H',W',C]."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    _cuda.check_tensor("image", image, (b, h, w, c))
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    lib = _cuda.load("warp")
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    with torch.cuda.device(image.device):
        err = lib.warp_fwd(image.data_ptr(), coords.data_ptr(), out.data_ptr(),
                           b, h, w, c, ho, wo, padding, _cuda.stream(image))
    if err != 0:
        raise RuntimeError(f"warp_fwd launch failed: cudaError {err}")
    launch_counts["warp_fwd"] += 1
    return out


def warp_bwd_cuda(image: torch.Tensor, coords: torch.Tensor, grad_out: torch.Tensor,
                  padding_mode: str = "zeros", need_image_grad: bool = False):
    """Backward kernel: returns (d image or None, d coords). d image is
    summed with atomics into a zeroed buffer, only when asked for."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    _cuda.check_tensor("image", image, (b, h, w, c))
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    _cuda.check_tensor("grad_out", grad_out, (b, ho, wo, c))
    lib = _cuda.load("warp")
    d_coords = torch.empty_like(coords)
    d_image = torch.zeros_like(image) if need_image_grad else None
    with torch.cuda.device(image.device):
        err = lib.warp_bwd(image.data_ptr(), coords.data_ptr(), grad_out.data_ptr(),
                           d_coords.data_ptr(),
                           d_image.data_ptr() if need_image_grad else None,
                           b, h, w, c, ho, wo, padding, _cuda.stream(image))
    if err != 0:
        raise RuntimeError(f"warp_bwd launch failed: cudaError {err}")
    launch_counts["warp_bwd"] += 1
    return d_image, d_coords


class _WarpCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, coords, padding_mode):
        out = warp_fwd_cuda(image, coords, padding_mode)
        ctx.save_for_backward(image, coords)
        ctx.padding_mode = padding_mode
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        image, coords = ctx.saved_tensors
        d_image, d_coords = warp_bwd_cuda(
            image, coords, grad_out.float().contiguous(), ctx.padding_mode,
            need_image_grad=ctx.needs_input_grad[0])
        return d_image, (d_coords if ctx.needs_input_grad[1] else None), None


def grid_sample(image: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``image`` [B, H, W, C] at ``coords`` [B, H', W', 2].

    ``coords[..., 0]`` is x and ``coords[..., 1]`` is y. CUDA tensors go
    through the kernels (in float32), CPU tensors through
    ``grid_sample_plain``.
    """
    _padding_code(padding_mode)
    _check_shapes(image, coords)
    if image.is_cuda and coords.is_cuda:
        return _WarpCuda.apply(image.float().contiguous(), coords.float().contiguous(),
                               padding_mode)
    if image.device.type == "cpu" and coords.device.type == "cpu":
        return grid_sample_plain(image, coords, padding_mode)
    raise ValueError(f"grid_sample has no path for devices {image.device} and {coords.device}")


def grid_sample_data(image: torch.Tensor, coords: torch.Tensor,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """``grid_sample`` where ``image`` is data, not a function of parameters
    (the photometric losses warp context frames): same forward, and the
    backward gives no gradient to the image, so d image is never computed."""
    return grid_sample(image.detach(), coords, padding_mode)


def grid_sample_plain(image: torch.Tensor, coords: torch.Tensor,
                      padding_mode: str = "zeros") -> torch.Tensor:
    """Plain PyTorch bilinear sample: four gathers at clamped indices, the
    validity masks of the 'zeros' mode, and the lerp. floor and the masks
    are piecewise constant, so autograd's gradient with respect to the
    coordinates flows through the lerp weights only."""
    border = _padding_code(padding_mode) == 1
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = image.reshape(b, h * w, c)

    def tap(ix, iy):
        ix_c = ix.clamp(0, w - 1).long()
        iy_c = iy.clamp(0, h - 1).long()
        idx = (iy_c * w + ix_c).reshape(b, ho * wo, 1).expand(b, ho * wo, c)
        out = torch.gather(flat, 1, idx).reshape(b, ho, wo, c)
        if border:
            return out
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        return out * valid[..., None].to(image.dtype)

    v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
    v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
