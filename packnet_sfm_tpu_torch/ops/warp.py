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
  lerp), differentiated by autograd in either mode. The CPU tests and
  ``chip_smoke.py`` hold the kernels to it.
- The backward: d coords through ``warp_bwd``, d image (only where the
  image requires a gradient; the losses warp data) through
  ``warp_bwd_image``, the transposed warp summed in one fixed order, so
  that the same inputs give the same bits on every run, as the JAX
  package's scatter-add does.
- Forward mode (``torch.func.jvp``, ``torch.autograd.forward_ad``): on CUDA
  the coordinates' tangent goes through ``warp_jvp`` (the direct pose
  alignment's Jacobian columns) and the image's through ``warp_fwd`` (the
  warp is linear in the image); with both, the two are added. On the CPU,
  ``grid_sample_plain`` under forward AD is their plain version.
- ``launch_counts``: launches of each kernel, counted where the wrapper
  launches it, so a run can show that its path went through the kernels;
  ``bf16_launch_counts`` those of the bfloat16-image variants
  (``warp_fwd_bf16``/``warp_bwd_bf16``/``warp_bwd_image_bf16``), which
  ``launch_counts`` leaves out.

The kernels compute in float32. A bfloat16 image at float32 coordinates
(what the bfloat16 policy's losses warp) goes to the bfloat16-image variants
as it is, with no float32 copy, and on the CPU to the plain version of the
image widened to float32 (the same function: the widening is exact); every
other pair of dtypes is cast to float32 first. On both devices the result
comes back in the dtype that the image's and the coordinates' promote to,
and each gradient or tangent in its input's dtype. A bfloat16 image's
gradient is JAX's float32 one on the widened image, rounded once; JAX's own
bfloat16 warp gives the image a zero gradient and tangent in 'zeros'
padding (ROADMAP.md §3 (w)), which the port does not copy.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

launch_counts = {"warp_fwd": 0, "warp_bwd": 0, "warp_jvp": 0, "warp_bwd_image": 0}
bf16_launch_counts = {"warp_fwd_bf16": 0, "warp_bwd_bf16": 0, "warp_bwd_image_bf16": 0}

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


def _kernel(name: str, dtype: torch.dtype) -> str:
    """The launcher of ``name`` for an image of ``dtype``."""
    return name + "_bf16" if dtype == torch.bfloat16 else name


def _count(name: str) -> None:
    (bf16_launch_counts if name.endswith("_bf16") else launch_counts)[name] += 1


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
    name = _kernel("warp_fwd", image.dtype)
    launcher = getattr(_cuda.load("warp"), name)
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    ptrs = [_with_storage(t).data_ptr() for t in (image, coords, out)]
    with torch.cuda.device(image.device):
        err = launcher(*ptrs, b, h, w, c, ho, wo, padding, _cuda.stream(image))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _count(name)
    return out


def warp_bwd_cuda(image: torch.Tensor, coords: torch.Tensor, grad_out: torch.Tensor,
                  padding_mode: str = "zeros", need_image_grad: bool = False,
                  need_coords_grad: bool = True):
    """Backward kernels: returns (d image or None, d coords or None), each
    only when asked for: d coords from ``warp_bwd`` (``warp_bwd_bf16`` for a
    bfloat16 image), d image from ``warp_bwd_image_cuda`` in the image's
    dtype."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    _cuda.check_tensor("image", image, (b, h, w, c), IMAGE_DTYPES)
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    _cuda.check_tensor("grad_out", grad_out, (b, ho, wo, c))
    d_coords = None
    if need_coords_grad:
        name = _kernel("warp_bwd", image.dtype)
        launcher = getattr(_cuda.load("warp"), name)
        d_coords = torch.empty_like(coords)
        with torch.cuda.device(image.device):
            err = launcher(image.data_ptr(), coords.data_ptr(), grad_out.data_ptr(),
                           d_coords.data_ptr(), b, h, w, c, ho, wo, padding,
                           _cuda.stream(image))
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        _count(name)
    d_image = (warp_bwd_image_cuda(coords, grad_out, (h, w), image.dtype, padding_mode)
               if need_image_grad else None)
    return d_image, d_coords


# warp_bwd_image's tiles (csrc/warp.cu TILE_H, TILE_W) and the records a
# tile's bin keeps (BIN_RECORDS), for the scratch the wrapper allocates.
IMAGE_GRAD_TILE = (8, 32)
IMAGE_GRAD_BIN_RECORDS = 256
INT32_MAX = 2 ** 31 - 1


def image_grad_plan(b: int, h: int, w: int, ho: int, wo: int) -> dict:
    """The tile grid of ``warp_bwd_image`` for d image [b, h, w, C] at an
    output grid [b, ho, wo] and its scratch in int32 elements: ``fill``, a
    record count a tile, and ``records``, BIN_RECORDS (warp, lanes) pairs a
    tile. Raises where an output pixel's or a tile's index leaves int32."""
    if min(b, h, w, ho, wo) < 1:
        raise ValueError(f"no image gradient of shape {(b, h, w)} at {(b, ho, wo)}")
    tiles = (-(-h // IMAGE_GRAD_TILE[0]), -(-w // IMAGE_GRAD_TILE[1]))
    n_tiles = b * tiles[0] * tiles[1]
    if b * ho * wo > INT32_MAX or n_tiles > INT32_MAX:
        raise ValueError(f"warp_bwd_image indexes its {b * ho * wo} output pixels and "
                         f"{n_tiles} tiles with int32")
    return {"tiles": tiles, "fill": n_tiles, "records": 2 * IMAGE_GRAD_BIN_RECORDS * n_tiles}


def warp_bwd_image_cuda(coords: torch.Tensor, grad_out: torch.Tensor, image_hw,
                        dtype: torch.dtype = torch.float32,
                        padding_mode: str = "zeros") -> torch.Tensor:
    """d image [B,H,W,C] of the warp of an image of ``image_hw`` = (H, W) at
    ``coords`` [B,H',W',2] under the cotangent ``grad_out`` [B,H',W',C]
    (both float32), in ``dtype`` (float32, or bfloat16 rounded once from
    the float32 sum): ``warp_bwd_image`` (``_bf16``), one launcher call of
    three device operations whose sums have one order on every run. Its
    scratch (``image_grad_plan``) may hold anything."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    h, w = image_hw
    b, ho, wo, c = grad_out.shape
    if dtype not in IMAGE_DTYPES or c < 1:
        raise ValueError(f"no image gradient of dtype {dtype} and shape {(b, h, w, c)}")
    plan = image_grad_plan(b, h, w, ho, wo)
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    _cuda.check_tensor("grad_out", grad_out, (b, ho, wo, c))
    name = _kernel("warp_bwd_image", dtype)
    launcher = getattr(_cuda.load("warp"), name)
    device = coords.device
    fill = torch.empty(plan["fill"], dtype=torch.int32, device=device)
    records = torch.empty(plan["records"], dtype=torch.int32, device=device)
    d_image = torch.empty((b, h, w, c), dtype=dtype, device=device)
    with torch.cuda.device(device):
        err = launcher(coords.data_ptr(), grad_out.data_ptr(), fill.data_ptr(),
                       records.data_ptr(), d_image.data_ptr(), b, h, w, c, ho, wo, padding,
                       _cuda.stream(coords))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _count(name)
    return d_image


def _with_storage(t: torch.Tensor) -> torch.Tensor:
    """``t`` without the wrappers of ``torch.func`` transforms, which have no
    storage of their own: under ``torch.func.jvp`` a jvp rule's saved
    inputs, tangents and new tensors are all so wrapped, and the tensor
    inside holds the data that a launcher reads or writes."""
    from torch._C import _functorch

    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t


def warp_jvp_cuda(image: torch.Tensor, coords: torch.Tensor, coords_tangent: torch.Tensor,
                  padding_mode: str = "zeros") -> torch.Tensor:
    """Coordinate-tangent kernel: the derivative of ``warp_fwd_cuda``'s
    output along ``coords_tangent`` [B,H',W',2] (float32), for a float32
    image -> [B,H',W',C] (float32)."""
    from packnet_sfm_tpu_torch.ops import _cuda

    padding = _padding_code(padding_mode)
    _check_shapes(image, coords)
    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    _cuda.check_tensor("image", image, (b, h, w, c))
    _cuda.check_tensor("coords", coords, (b, ho, wo, 2))
    _cuda.check_tensor("coords_tangent", coords_tangent, (b, ho, wo, 2))
    launcher = _cuda.load("warp").warp_jvp
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    ptrs = [_with_storage(t).data_ptr() for t in (image, coords, coords_tangent, out)]
    with torch.cuda.device(image.device):
        err = launcher(*ptrs, b, h, w, c, ho, wo, padding, _cuda.stream(image))
    if err != 0:
        raise RuntimeError(f"warp_jvp launch failed: cudaError {err}")
    _count("warp_jvp")
    return out


class _WarpCuda(torch.autograd.Function):
    """The kernels as one differentiable function of (image, coords):
    ``backward`` through ``warp_bwd`` (d coords) and ``warp_bwd_image``
    (d image), ``jvp`` (forward mode) through ``warp_jvp`` (the
    coordinates' tangent) and ``warp_fwd`` (the image's). In the
    ``setup_context`` form, so that ``torch.func`` transforms take it as
    well as ``torch.autograd``."""

    @staticmethod
    def forward(image, coords, padding_mode):
        return warp_fwd_cuda(image, coords, padding_mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        image, coords, padding_mode = inputs
        ctx.save_for_backward(image, coords)
        ctx.save_for_forward(image, coords)
        ctx.padding_mode = padding_mode
        # an input without a tangent (or an output without a gradient) comes
        # as None, not as zeros: so an image tangent is seen for what it is
        ctx.set_materialize_grads(False)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        if grad_out is None:
            return None, None, None
        image, coords = ctx.saved_tensors
        d_image, d_coords = warp_bwd_cuda(
            image, coords, grad_out.float().contiguous(), ctx.padding_mode,
            need_image_grad=ctx.needs_input_grad[0], need_coords_grad=ctx.needs_input_grad[1])
        return d_image, d_coords, None

    @staticmethod
    def jvp(ctx, image_t, coords_t, _):
        image, coords = ctx.saved_tensors
        out_t = None
        if image_t is not None:
            out_t = warp_fwd_cuda(image_t.contiguous(), coords, ctx.padding_mode)
        if coords_t is not None:
            # a bfloat16 image widens to float32 exactly: JAX's tangent is this
            part = warp_jvp_cuda(image.float(), coords, coords_t.float().contiguous(),
                                 ctx.padding_mode)
            out_t = part if out_t is None else out_t + part
        return out_t


def grid_sample(image: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``image`` [B, H, W, C] at ``coords`` [B, H', W', 2].

    ``coords[..., 0]`` is x and ``coords[..., 1]`` is y. CUDA tensors go
    through the kernels (in float32, cast back to the inputs' promoted dtype
    outside the autograd function; a bfloat16 image at float32 coordinates
    through the bfloat16-image variants, uncast), CPU tensors through
    ``grid_sample_plain`` (a bfloat16 image at float32 coordinates widened
    to float32, so that its gradient is summed in float32 as on the card).
    """
    _padding_code(padding_mode)
    _check_shapes(image, coords)
    bf16_image = image.dtype == torch.bfloat16 and coords.dtype == torch.float32
    if image.is_cuda and coords.is_cuda:
        out_dtype = torch.promote_types(image.dtype, coords.dtype)
        if not bf16_image:
            image = image.float()
        out = _WarpCuda.apply(image.contiguous(), coords.float().contiguous(), padding_mode)
        return out.to(out_dtype)
    if image.device.type == "cpu" and coords.device.type == "cpu":
        return grid_sample_plain(image.float() if bf16_image else image, coords, padding_mode)
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
