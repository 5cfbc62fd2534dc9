"""Streaming patch soft-argmax for the NRS generic camera (kernels K6f/K6b).

Port of ``packnet_sfm_tpu/ops/pallas_softargmax.py``. For each pixel of a
direction field, a softmax over dot(direction, ray) / T in its border-clamped
(2p+1)^2 window of the reference ray surface gives the expected window
coordinates (ex, ey).

- ``softargmax_coords``: the entry point. On CUDA tensors its forward and
  backward are the hand-written kernels of ``csrc/softargmax.cu``; on CPU
  tensors it is ``softargmax_coords_plain``. Any other device raises.
  The forward saves m, the largest dot of each window (the largest logit
  times T), and s, the sum of exp(logit - largest logit). The backward is
  one launch of two gathers: d direction by pixel over its window, d rays
  by ray position over the pixels whose windows hold it
  (``transposed_window_bounds``). It uses no atomics and writes every
  element once, so two calls on the same inputs return the same bits.
- ``softargmax_coords_plain``: plain PyTorch (row-chunked dense window
  softmax, as the JAX package's XLA path), differentiated by autograd. The
  CPU tests and ``chip_smoke.py`` hold the kernels to it.
- ``launch_counts``: launches of each kernel, counted where the wrapper
  launches it, so a run can show that its path went through the kernels;
  ``band_launch_counts`` those of the band forms.

The band form (``row0``, ``height``, ``ray_row0``): on a band of rows of the
(data x space) grid (``parallel/spatial.py``) the direction field holds the
global rows [row0, row0 + h) of an image of ``height`` rows, and ``rays``
a slab of the ray surface, its global rows [ray_row0, ray_row0 + hr), which
holds every window of those rows (``ray_slab``). The windows are the whole
image's (start clamp(y - p, 0, height - k) of the global row y) and ey is a
global row; d rays is the slab's, whose rows of other bands go back to them
through the halo's backward. On CUDA tensors it runs the band forms of the
kernels (``softargmax_fwd_band``/``softargmax_bwd_band``).

The temperature is a Python float chosen on the host
(``geometry.camera_generic.projection_temperature``) and handed to the
kernel as an argument.
"""

from __future__ import annotations

import torch

from typing import Optional

launch_counts = {"softargmax_fwd": 0, "softargmax_bwd": 0}
band_launch_counts = {"softargmax_fwd_band": 0, "softargmax_bwd_band": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, band_launch_counts):
        for key in counts:
            counts[key] = 0


def _check_window(h: int, w: int, patch: int) -> None:
    k = 2 * patch + 1
    if patch < 0 or h < k or w < k:
        raise ValueError(f"soft-argmax window {k}x{k} needs h, w >= {k}; got {h}x{w}")


def _check_temperature(temperature) -> float:
    if isinstance(temperature, torch.Tensor) or not temperature > 0.0:
        raise ValueError("temperature must be a positive Python float chosen on "
                         f"the host, got {temperature!r}")
    return float(temperature)


def transposed_window_bounds(n: int, patch: int, row0: int = 0, rows: Optional[int] = None,
                             ray_row0: int = 0, ray_rows: Optional[int] = None):
    """Along an axis of length ``n``: for each ray position r, the first and
    last pixel whose border-clamped window (start clamp(x - p, 0, n - k),
    k = 2p + 1) holds r, as two int64 tensors [n]. The pixels between them
    all hold r. Windows near a border are pushed inwards, so the interval is
    not k long: 3p + 1 pixels hold the ray at 2p, and where n <= 4p + 1 some
    rays are held by every pixel. The backward kernel's d rays role
    gathers over these intervals (``win_lo``/``win_hi`` in
    ``csrc/softargmax.cu``).

    On a band (the band form): for the rays [ray_row0, ray_row0 +
    ray_rows), the interval cut to the pixels [row0, row0 + rows) and
    counted from row0; empty (lo > hi) where no pixel of the band holds the
    ray."""
    k = 2 * patch + 1
    if patch < 0 or n < k:
        raise ValueError(f"window {k} needs an axis of at least {k}, got {n}")
    rows = n - row0 if rows is None else rows
    ray_rows = n - ray_row0 if ray_rows is None else ray_rows
    r = torch.arange(ray_row0, ray_row0 + ray_rows)
    lo = torch.where(r <= 2 * patch, torch.zeros_like(r), r - patch)
    hi = torch.where(r >= n - k, torch.full_like(r, n - 1), r + patch)
    return lo.clamp(min=row0) - row0, hi.clamp(max=row0 + rows - 1) - row0


def ray_slab(row0: int, rows: int, height: int, patch: int):
    """(first, stop): the global rows of the ray surface that the windows of
    the direction rows [row0, row0 + rows) of an image of ``height`` rows
    read, [clamp(row0 - p, 0, height - k), clamp(row0 + rows - 1 - p, 0,
    height - k) + k)."""
    k = 2 * patch + 1
    first = min(max(row0 - patch, 0), height - k)
    return first, min(max(row0 + rows - 1 - patch, 0), height - k) + k


def _check_band(h: int, hr: int, w: int, patch: int, row0: int, height: int,
                ray_row0: int) -> None:
    """Refuse a band form whose rows are not a band of the image or whose ray
    slab does not hold every window of them (as ``bad_shape`` in
    ``csrc/softargmax.cu``)."""
    _check_window(height, w, patch)
    first, stop = ray_slab(row0, h, height, patch)
    if not (0 <= row0 and row0 + h <= height and 0 <= ray_row0 <= first
            and stop <= ray_row0 + hr <= height):
        raise ValueError(f"a band of rows [{row0}, {row0 + h}) of {height} needs the ray rows "
                         f"[{first}, {stop}); got [{ray_row0}, {ray_row0 + hr})")


def softargmax_fwd_cuda(direction, rays, temperature: float, patch: int):
    """Forward kernel: direction, rays [B,3,h,w] -> ex, ey, m, s [B,h,w];
    m is the window's largest dot (not divided by T)."""
    from packnet_sfm_tpu_torch.ops import _cuda

    b, _, h, w = direction.shape
    _check_window(h, w, patch)
    temperature = _check_temperature(temperature)
    _cuda.check_tensor("direction", direction, (b, 3, h, w))
    _cuda.check_tensor("rays", rays, (b, 3, h, w))
    lib = _cuda.load("softargmax")
    ex, ey, m, s = (torch.empty((b, h, w), dtype=torch.float32, device=direction.device)
                    for _ in range(4))
    with torch.cuda.device(direction.device):
        err = lib.softargmax_fwd(direction.data_ptr(), rays.data_ptr(), ex.data_ptr(),
                                 ey.data_ptr(), m.data_ptr(), s.data_ptr(), b, h, w,
                                 patch, temperature, _cuda.stream(direction))
    if err != 0:
        raise RuntimeError(f"softargmax_fwd launch failed: cudaError {err}")
    launch_counts["softargmax_fwd"] += 1
    return ex, ey, m, s


def softargmax_bwd_cuda(direction, rays, temperature: float, patch: int,
                        ex, ey, m, s, gex, gey):
    """Backward kernel: replays the windows with the forward's (m, s) and
    returns (d direction, d rays), both [B,3,h,w], every element written
    once by one launch."""
    from packnet_sfm_tpu_torch.ops import _cuda

    b, _, h, w = direction.shape
    _check_window(h, w, patch)
    temperature = _check_temperature(temperature)
    _cuda.check_tensor("direction", direction, (b, 3, h, w))
    _cuda.check_tensor("rays", rays, (b, 3, h, w))
    for name, t in (("ex", ex), ("ey", ey), ("m", m), ("s", s),
                    ("gex", gex), ("gey", gey)):
        _cuda.check_tensor(name, t, (b, h, w))
    lib = _cuda.load("softargmax")
    ddir = torch.empty_like(direction)
    drays = torch.empty_like(rays)
    with torch.cuda.device(direction.device):
        err = lib.softargmax_bwd(direction.data_ptr(), rays.data_ptr(), ex.data_ptr(),
                                 ey.data_ptr(), m.data_ptr(), s.data_ptr(),
                                 gex.data_ptr(), gey.data_ptr(), ddir.data_ptr(),
                                 drays.data_ptr(), b, h, w, patch, temperature,
                                 _cuda.stream(direction))
    if err != 0:
        raise RuntimeError(f"softargmax_bwd launch failed: cudaError {err}")
    launch_counts["softargmax_bwd"] += 1
    return ddir, drays


def softargmax_fwd_band_cuda(direction, rays, temperature: float, patch: int, row0: int,
                             height: int, ray_row0: int):
    """K6f's band form: direction [B,3,h,w] (global rows row0 on of an image
    of ``height`` rows), the ray slab [B,3,hr,w] (from ``ray_row0``) ->
    ex, ey, m, s [B,h,w]; ey is a global row."""
    from packnet_sfm_tpu_torch.ops import _cuda

    b, _, h, w = direction.shape
    hr = rays.shape[2]
    _check_band(h, hr, w, patch, row0, height, ray_row0)
    temperature = _check_temperature(temperature)
    _cuda.check_tensor("direction", direction, (b, 3, h, w))
    _cuda.check_tensor("rays", rays, (b, 3, hr, w))
    lib = _cuda.load("softargmax")
    ex, ey, m, s = (torch.empty((b, h, w), dtype=torch.float32, device=direction.device)
                    for _ in range(4))
    with torch.cuda.device(direction.device):
        err = lib.softargmax_fwd_band(direction.data_ptr(), rays.data_ptr(), ex.data_ptr(),
                                      ey.data_ptr(), m.data_ptr(), s.data_ptr(), b, h, hr, w,
                                      height, row0, ray_row0, patch, temperature,
                                      _cuda.stream(direction))
    if err != 0:
        raise RuntimeError(f"softargmax_fwd_band launch failed: cudaError {err}")
    band_launch_counts["softargmax_fwd_band"] += 1
    return ex, ey, m, s


def softargmax_bwd_band_cuda(direction, rays, temperature: float, patch: int, row0: int,
                             height: int, ray_row0: int, ex, ey, m, s, gex, gey):
    """K6b's band form: (d direction [B,3,h,w], d rays of the slab
    [B,3,hr,w]), every element written once by one launch."""
    from packnet_sfm_tpu_torch.ops import _cuda

    b, _, h, w = direction.shape
    hr = rays.shape[2]
    _check_band(h, hr, w, patch, row0, height, ray_row0)
    temperature = _check_temperature(temperature)
    _cuda.check_tensor("direction", direction, (b, 3, h, w))
    _cuda.check_tensor("rays", rays, (b, 3, hr, w))
    for name, t in (("ex", ex), ("ey", ey), ("m", m), ("s", s),
                    ("gex", gex), ("gey", gey)):
        _cuda.check_tensor(name, t, (b, h, w))
    lib = _cuda.load("softargmax")
    ddir = torch.empty_like(direction)
    drays = torch.empty_like(rays)
    with torch.cuda.device(direction.device):
        err = lib.softargmax_bwd_band(direction.data_ptr(), rays.data_ptr(), ex.data_ptr(),
                                      ey.data_ptr(), m.data_ptr(), s.data_ptr(),
                                      gex.data_ptr(), gey.data_ptr(), ddir.data_ptr(),
                                      drays.data_ptr(), b, h, hr, w, height, row0, ray_row0,
                                      patch, temperature, _cuda.stream(direction))
    if err != 0:
        raise RuntimeError(f"softargmax_bwd_band launch failed: cudaError {err}")
    band_launch_counts["softargmax_bwd_band"] += 1
    return ddir, drays


class _SoftargmaxCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, direction, rays, temperature, patch):
        ex, ey, m, s = softargmax_fwd_cuda(direction, rays, temperature, patch)
        ctx.save_for_backward(direction, rays, ex, ey, m, s)
        ctx.temperature, ctx.patch = temperature, patch
        return ex, ey

    @staticmethod
    def backward(ctx, gex, gey):
        direction, rays, ex, ey, m, s = ctx.saved_tensors
        gex = torch.zeros_like(ex) if gex is None else gex.float().contiguous()
        gey = torch.zeros_like(ey) if gey is None else gey.float().contiguous()
        ddir, drays = softargmax_bwd_cuda(direction, rays, ctx.temperature, ctx.patch,
                                          ex, ey, m, s, gex, gey)
        return ddir, drays, None, None


class _SoftargmaxBandCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, direction, rays, temperature, patch, row0, height, ray_row0):
        args = (temperature, patch, row0, height, ray_row0)
        ex, ey, m, s = softargmax_fwd_band_cuda(direction, rays, *args)
        ctx.save_for_backward(direction, rays, ex, ey, m, s)
        ctx.args = args
        return ex, ey

    @staticmethod
    def backward(ctx, gex, gey):
        direction, rays, ex, ey, m, s = ctx.saved_tensors
        gex = torch.zeros_like(ex) if gex is None else gex.float().contiguous()
        gey = torch.zeros_like(ey) if gey is None else gey.float().contiguous()
        ddir, drays = softargmax_bwd_band_cuda(direction, rays, *ctx.args, ex, ey, m, s,
                                               gex, gey)
        return ddir, drays, None, None, None, None, None


def softargmax_coords(direction: torch.Tensor, rays: torch.Tensor,
                      temperature: float, patch: int, row0: int = 0,
                      height: Optional[int] = None, ray_row0: int = 0):
    """Expected window coords for NRS projection.

    direction, rays: [B, 3, h, w] (unit vectors, channels leading). Returns
    (ex, ey): [B, h, w] absolute pixel coords, float32. CUDA tensors go
    through the kernels, CPU tensors through ``softargmax_coords_plain``.
    Both compute in float32 on any input, as the JAX kernels do (no
    bfloat16 variant); the gradients come back in the inputs' dtypes.
    With ``height``, the band form (see the module docstring): direction
    the rows from ``row0`` of an image of ``height`` rows, rays the slab
    from ``ray_row0``.
    """
    temperature = _check_temperature(temperature)
    band = () if height is None else (row0, height, ray_row0)
    if direction.is_cuda:
        args = (direction.float().contiguous(), rays.float().contiguous(), temperature, patch)
        return _SoftargmaxBandCuda.apply(*args, *band) if band else _SoftargmaxCuda.apply(*args)
    if direction.device.type == "cpu":
        return softargmax_coords_plain(direction, rays, temperature, patch, row0=row0,
                                       height=height, ray_row0=ray_row0)
    raise ValueError(f"softargmax_coords has no path for device {direction.device}")


def softargmax_coords_plain(direction: torch.Tensor, rays: torch.Tensor,
                            temperature: float, patch: int, row_chunk: int = 8,
                            row0: int = 0, height: Optional[int] = None, ray_row0: int = 0):
    """Plain PyTorch soft-argmax: per chunk of rows, the dense window logits
    [B, rc, w, k, k], a softmax and the coordinate expectation (as
    ``packnet_sfm_tpu/geometry/camera_generic.py``'s XLA path). With
    ``height``, the band form (see ``softargmax_coords``)."""
    b, _, h, w = direction.shape
    k = 2 * patch + 1
    if height is None:
        _check_window(h, w, patch)
        height = h
    else:
        _check_band(h, rays.shape[2], w, patch, row0, height, ray_row0)
    dev = direction.device
    # the window starts of the global rows, as rows of ``rays``
    sy = (torch.arange(row0, row0 + h, device=dev) - patch).clamp(0, height - k) - ray_row0
    sx = (torch.arange(w, device=dev) - patch).clamp(0, w - k)
    kk = torch.arange(k, device=dev)
    kf = kk.to(torch.float32)
    cols = sx[:, None] + kk[None, :]                                 # [w, k]
    dirs = direction.permute(0, 2, 3, 1).float()                     # [B, h, w, 3]
    rayt = rays.permute(0, 2, 3, 1).float()
    exs, eys = [], []
    for r0 in range(0, h, row_chunk):
        sy_r = sy[r0:r0 + row_chunk]
        rc = sy_r.shape[0]
        rows = rayt[:, sy_r[:, None] + kk[None, :]]                  # [B, rc, k, w, 3]
        win = rows[:, :, :, cols]                                    # [B, rc, k, w, k, 3]
        logits = torch.einsum("brwc,brywxc->brwyx", dirs[:, r0:r0 + rc], win)
        prob = torch.softmax(logits.reshape(b, rc, w, k * k) / temperature, dim=-1)
        prob = prob.reshape(b, rc, w, k, k)
        eys.append(prob.sum(4) @ kf + (sy_r + ray_row0).to(torch.float32)[None, :, None])
        exs.append(prob.sum(3) @ kf + sx.to(torch.float32)[None, None, :])
    return torch.cat(exs, dim=1), torch.cat(eys, dim=1)
