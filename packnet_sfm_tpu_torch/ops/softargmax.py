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
  launches it, so a run can show that its path went through the kernels.

The temperature is a Python float chosen on the host
(``geometry.camera_generic.projection_temperature``) and handed to the
kernel as an argument.
"""

from __future__ import annotations

import torch

launch_counts = {"softargmax_fwd": 0, "softargmax_bwd": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def _check_window(h: int, w: int, patch: int) -> None:
    k = 2 * patch + 1
    if patch < 0 or h < k or w < k:
        raise ValueError(f"soft-argmax window {k}x{k} needs h, w >= {k}; got {h}x{w}")


def _check_temperature(temperature) -> float:
    if isinstance(temperature, torch.Tensor) or not temperature > 0.0:
        raise ValueError("temperature must be a positive Python float chosen on "
                         f"the host, got {temperature!r}")
    return float(temperature)


def transposed_window_bounds(n: int, patch: int):
    """Along an axis of length ``n``: for each ray position r, the first and
    last pixel whose border-clamped window (start clamp(x - p, 0, n - k),
    k = 2p + 1) holds r, as two int64 tensors [n]. The pixels between them
    all hold r. Windows near a border are pushed inwards, so the interval is
    not k long: 3p + 1 pixels hold the ray at 2p, and where n <= 4p + 1 some
    rays are held by every pixel. The backward kernel's d rays role
    gathers over these intervals (``win_lo``/``win_hi`` in
    ``csrc/softargmax.cu``)."""
    k = 2 * patch + 1
    if patch < 0 or n < k:
        raise ValueError(f"window {k} needs an axis of at least {k}, got {n}")
    r = torch.arange(n)
    lo = torch.where(r <= 2 * patch, torch.zeros_like(r), r - patch)
    hi = torch.where(r >= n - k, torch.full_like(r, n - 1), r + patch)
    return lo, hi


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


def softargmax_coords(direction: torch.Tensor, rays: torch.Tensor,
                      temperature: float, patch: int):
    """Expected window coords for NRS projection.

    direction, rays: [B, 3, h, w] (unit vectors, channels leading). Returns
    (ex, ey): [B, h, w] absolute pixel coords, float32. CUDA tensors go
    through the kernels, CPU tensors through ``softargmax_coords_plain``.
    Both compute in float32 on any input, as the JAX kernels do (no
    bfloat16 variant); the gradients come back in the inputs' dtypes.
    """
    temperature = _check_temperature(temperature)
    if direction.is_cuda:
        return _SoftargmaxCuda.apply(direction.float().contiguous(), rays.float().contiguous(),
                                     temperature, patch)
    if direction.device.type == "cpu":
        return softargmax_coords_plain(direction, rays, temperature, patch)
    raise ValueError(f"softargmax_coords has no path for device {direction.device}")


def softargmax_coords_plain(direction: torch.Tensor, rays: torch.Tensor,
                            temperature: float, patch: int, row_chunk: int = 8):
    """Plain PyTorch soft-argmax: per chunk of rows, the dense window logits
    [B, rc, w, k, k], a softmax and the coordinate expectation (as
    ``packnet_sfm_tpu/geometry/camera_generic.py``'s XLA path)."""
    b, _, h, w = direction.shape
    _check_window(h, w, patch)
    k = 2 * patch + 1
    dev = direction.device
    sy = (torch.arange(h, device=dev) - patch).clamp(0, h - k)
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
        eys.append(prob.sum(4) @ kf + sy_r.to(torch.float32)[None, :, None])
        exs.append(prob.sum(3) @ kf + sx.to(torch.float32)[None, None, :])
    return torch.cat(exs, dim=1), torch.cat(eys, dim=1)
