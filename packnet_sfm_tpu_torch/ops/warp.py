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
  launches it, so a run can show that its path went through the kernels;
  ``bf16_launch_counts`` those of the bfloat16-image variants
  (``warp_fwd_bf16``/``warp_bwd_bf16``), which ``launch_counts`` leaves
  out.

The kernels compute in float32. A bfloat16 image at float32 coordinates
(what the bfloat16 policy's losses warp) goes to the bfloat16-image variants
as it is, with no float32 copy; every other pair of dtypes is cast to
float32 first. On both devices the result comes back in the dtype that the
image's and the coordinates' promote to, and the gradient with respect to
the coordinates in the coordinates' dtype. The variants give no gradient to
the image: asked for one, the backward raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

launch_counts = {"warp_fwd": 0, "warp_bwd": 0}
bf16_launch_counts = {"warp_fwd_bf16": 0, "warp_bwd_bf16": 0}

PADDING_MODES = {"zeros": 0, "border": 1}


def reset_launch_counts() -> None:
    for counts in (launch_counts, bf16_launch_counts):
        for key in counts:
            counts[key] = 0


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


IMAGE_DTYPES = (torch.float32, torch.bfloat16)


def _kernel(name: str, image: torch.Tensor) -> str:
    """The launcher of ``name`` for the image's dtype."""
    return name + "_bf16" if image.dtype == torch.bfloat16 else name


def warp_fwd_cuda(image: torch.Tensor, coords: torch.Tensor,
                  padding_mode: str = "zeros") -> torch.Tensor:
    """Forward kernel: image [B,H,W,C] (float32 or bfloat16), coords
    [B,H',W',2] (float32) -> [B,H',W',C] (float32)."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    _cuda.check_tensor("image", image, (b, h, w, c), IMAGE_DTYPES)
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    name = _kernel("warp_fwd", image)
    launcher = getattr(_cuda.load("warp"), name)
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    with torch.cuda.device(image.device):
        err = launcher(image.data_ptr(), coords.data_ptr(), out.data_ptr(),
                       b, h, w, c, ho, wo, padding, _cuda.stream(image))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    (bf16_launch_counts if name.endswith("_bf16") else launch_counts)[name] += 1
    return out


def warp_bwd_cuda(image: torch.Tensor, coords: torch.Tensor, grad_out: torch.Tensor,
                  padding_mode: str = "zeros", need_image_grad: bool = False):
    """Backward kernel: returns (d image or None, d coords). d image is
    summed with atomics into a zeroed buffer, only when asked for, and only
    for a float32 image: for a bfloat16 one it raises."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    _cuda.check_tensor("image", image, (b, h, w, c), IMAGE_DTYPES)
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    _cuda.check_tensor("grad_out", grad_out, (b, ho, wo, c))
    name = _kernel("warp_bwd", image)
    if need_image_grad and image.dtype != torch.float32:
        raise ValueError(f"{name} gives no gradient to a {image.dtype} image; "
                         "warp a float32 image where it needs one")
    launcher = getattr(_cuda.load("warp"), name)
    d_coords = torch.empty_like(coords)
    d_image = torch.zeros_like(image) if need_image_grad else None
    image_grad = [d_image.data_ptr() if need_image_grad else None]
    with torch.cuda.device(image.device):
        err = launcher(image.data_ptr(), coords.data_ptr(), grad_out.data_ptr(),
                       d_coords.data_ptr(), *(image_grad if name == "warp_bwd" else []),
                       b, h, w, c, ho, wo, padding, _cuda.stream(image))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    (bf16_launch_counts if name.endswith("_bf16") else launch_counts)[name] += 1
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
    through the kernels (in float32, cast back to the inputs' promoted dtype
    outside the autograd function; a bfloat16 image at float32 coordinates
    through the bfloat16-image variants, uncast), CPU tensors through
    ``grid_sample_plain``.
    """
    _padding_code(padding_mode)
    _check_shapes(image, coords)
    if image.is_cuda and coords.is_cuda:
        out_dtype = torch.promote_types(image.dtype, coords.dtype)
        if not (image.dtype == torch.bfloat16 and coords.dtype == torch.float32):
            image = image.float()
        elif image.requires_grad and torch.is_grad_enabled():
            raise ValueError("the bfloat16-image warp gives no gradient to the image; "
                             "detach it (grid_sample_data) or warp it in float32")
        out = _WarpCuda.apply(image.contiguous(), coords.float().contiguous(), padding_mode)
        return out.to(out_dtype)
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
