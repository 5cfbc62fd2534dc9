"""On-device color jitter: brightness, contrast, saturation, hue (port of
``ops/jitter.py``).

The host draws the per-sample factors (``datasets/augmentations.
draw_jitter_params``) and ships uint8 images plus a [B, 4] factor array;
the elementwise jitter runs on the device inside the train step:
    out = (img * b - mean(img*b)) * c + mean(img*b)        # brightness+contrast
    out = (out - gray(out)) * s + gray(out)                # saturation
    clip to [0, 1]; hue-rotate in continuous float HSV
with the same factors for the target and every context frame of a sample.
"""

from __future__ import annotations

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0,1] -> HSV with H in [0,1) (continuous)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    spread = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, spread / maxc.clamp(min=1e-12), zero)
    safe = spread.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(spread > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """[..., 3] HSV (H in [0,1)) -> RGB in [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)

    def select(choices):
        return torch.stack(choices, dim=-1).gather(-1, i[..., None])[..., 0]

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def apply_jitter(image: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Jitter [B, H, W, 3] float images with per-sample factors [B, 4].

    params columns: (brightness b, contrast c, saturation s, hue shift h);
    a row of (1, 1, 1, 0) is the identity.
    """
    b = params[:, 0][:, None, None, None]
    c = params[:, 1][:, None, None, None]
    s = params[:, 2][:, None, None, None]
    hshift = params[:, 3][:, None, None]
    # brightness + contrast collapse into one affine around the channel mean
    mean = image.reshape(image.shape[0], -1, 3).mean(dim=1)        # [B, 3]
    mean = mean[:, None, None, :] * (b * (1.0 - c))
    out = image * (b * c) + mean
    gray = out.sum(dim=-1, keepdim=True) * ((1.0 - s) / 3.0)
    out = (out * s + gray).clamp(0.0, 1.0)
    hsv = rgb_to_hsv(out)
    h_rot = torch.remainder(hsv[..., 0] + hshift, 1.0)
    rot = hsv_to_rgb(torch.stack([h_rot, hsv[..., 1], hsv[..., 2]], dim=-1))
    return rot.clamp(0.0, 1.0)
