"""Plain PyTorch losses, geometry and input preparation of the benchmark's
configurations, from the PackNet-SfM and PackNet-SAN descriptions: the
colour jitter, the pinhole view synthesis (``F.grid_sample``), the L1 +
SSIM photometric loss with the automask and the min over contexts, the
edge-aware smoothness, and the sparse L1 on inverse depth. NHWC images, in
the dtype of their inputs (float64 for the check's truth). Imports nothing
of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SSIM_WEIGHT, SMOOTH_WEIGHT, C1, C2 = 0.85, 0.001, 1e-4, 9e-4


# ---- the device half of the input pipeline ------------------------------

def to_float(x, device, dtype=torch.float32) -> torch.Tensor:
    """A host array as ``dtype`` on ``device``; uint8 scaled to [0, 1]."""
    t = torch.as_tensor(x).to(device)
    return t.to(dtype) / 255.0 if t.dtype == torch.uint8 else t.to(dtype)


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    spread = maxc - minc
    s = torch.where(maxc > 0, spread / maxc.clamp(min=1e-12), torch.zeros_like(maxc))
    safe = spread.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(spread > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(maxc))
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)[..., None]

    def pick(*choices):
        return torch.stack(choices, -1).gather(-1, i)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def jitter(image, params):
    """Brightness, contrast, saturation and hue of [B, H, W, 3] images in
    [0, 1], by the per-sample factors [B, 4] (b, c, s, hue shift)."""
    b, c, s = (params[:, k].view(-1, 1, 1, 1) for k in range(3))
    mean = image.mean(dim=(1, 2), keepdim=True) * b
    out = (image * b - mean) * c + mean
    gray = out.mean(dim=-1, keepdim=True)
    out = ((out - gray) * s + gray).clamp(0.0, 1.0)
    h, sat, v = _rgb_to_hsv(out)
    h = torch.remainder(h + params[:, 3].view(-1, 1, 1), 1.0)
    return _hsv_to_rgb(h, sat, v).clamp(0.0, 1.0)


# ---- geometry ------------------------------------------------------------

def pose_vec_to_mat(vec):
    """[B, 6] (tx ty tz rx ry rz) -> [B, 4, 4], R = Rx Ry Rz."""
    x, y, z = vec[:, 3], vec[:, 4], vec[:, 5]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([one, zero, zero, zero, x.cos(), -x.sin(), zero, x.sin(), x.cos()], -1)
    ry = torch.stack([y.cos(), zero, y.sin(), zero, one, zero, -y.sin(), zero, y.cos()], -1)
    rz = torch.stack([z.cos(), -z.sin(), zero, z.sin(), z.cos(), zero, zero, zero, one], -1)
    rot = rx.view(-1, 3, 3) @ ry.view(-1, 3, 3) @ rz.view(-1, 3, 3)
    top = torch.cat([rot, vec[:, :3, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=vec.dtype,
                          device=vec.device).expand(vec.shape[0], 1, 4)
    return torch.cat([top, bottom], 1)


def scale_intrinsics(K, s):
    """Intrinsics of an image resized by ``s`` (pixel centres at +0.5)."""
    out = torch.zeros_like(K)
    out[:, 0, 0] = K[:, 0, 0] * s
    out[:, 1, 1] = K[:, 1, 1] * s
    out[:, 0, 2] = (K[:, 0, 2] + 0.5) * s - 0.5
    out[:, 1, 2] = (K[:, 1, 2] + 0.5) * s - 0.5
    out[:, 2, 2] = 1.0
    return out


def view_synthesis(ref_image, depth, K, T):
    """Warp ``ref_image`` [B, H, W, 3] into the target frame through the
    target's ``depth`` [B, H, W, 1], intrinsics K [B, 3, 3] (both frames)
    and the target->context transform T [B, 4, 4]; zeros outside."""
    b, h, w, _ = depth.shape
    v, u = torch.meshgrid(torch.arange(h, device=depth.device, dtype=depth.dtype),
                          torch.arange(w, device=depth.device, dtype=depth.dtype),
                          indexing="ij")
    fx, fy = K[:, 0, 0].view(-1, 1, 1), K[:, 1, 1].view(-1, 1, 1)
    cx, cy = K[:, 0, 2].view(-1, 1, 1), K[:, 1, 2].view(-1, 1, 1)
    d = depth[..., 0]
    pts = torch.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], -1)       # camera frame
    # the target camera is the world; the context's is T applied to it
    pts = torch.einsum("bij,bhwj->bhwi", T[:, :3, :3], pts) + T[:, None, None, :3, 3]
    z = pts[..., 2].clamp(min=1e-5)
    pu = fx * pts[..., 0] / z + cx
    pv = fy * pts[..., 1] / z + cy
    grid = torch.stack([2.0 * pu / (w - 1) - 1.0, 2.0 * pv / (h - 1) - 1.0], -1)
    out = F.grid_sample(ref_image.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def resize(image, shape, mode="bilinear"):
    """[B, H, W, C] to ``shape``: bilinear with aligned corners, or nearest
    at floor((i + 0.5) S / S')."""
    if tuple(image.shape[1:3]) == tuple(shape):
        return image
    x = image.permute(0, 3, 1, 2)
    if mode == "bilinear":
        x = F.interpolate(x, size=tuple(shape), mode="bilinear", align_corners=True)
    else:
        x = F.interpolate(x, size=tuple(shape), mode="nearest-exact")
    return x.permute(0, 2, 3, 1)


# ---- losses --------------------------------------------------------------

def ssim_distance(x, y):
    """(1 - SSIM) / 2 over 3x3 windows of reflection-padded NHWC images."""
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    pool = lambda t: F.avg_pool2d(t, 3, 1)             # noqa: E731
    mx, my = pool(x), pool(y)
    sx = pool(x * x) - mx * mx
    sy = pool(y * y) - my * my
    sxy = pool(x * y) - mx * my
    ssim = ((2 * mx * my + C1) * (2 * sxy + C2)) / ((mx * mx + my * my + C1) * (sx + sy + C2))
    return ((1.0 - ssim) * 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def photometric_map(est, ref):
    l1 = (est - ref).abs().mean(-1, keepdim=True)
    return SSIM_WEIGHT * ssim_distance(est, ref).mean(-1, keepdim=True) + (1 - SSIM_WEIGHT) * l1


def smoothness(inv_depths, images):
    """Edge-aware smoothness of the mean-normalized inverse depths, 1/2^i a
    scale, times the weight, over the scale count."""
    total = 0.0
    for i, (d, im) in enumerate(zip(inv_depths, images)):
        d = d / d.mean(dim=(1, 2), keepdim=True).clamp(min=1e-6)
        gx = lambda t: t[:, :, :-1] - t[:, :, 1:]      # noqa: E731
        gy = lambda t: t[:, :-1] - t[:, 1:]            # noqa: E731
        wx = torch.exp(-gx(im).abs().mean(-1, keepdim=True))
        wy = torch.exp(-gy(im).abs().mean(-1, keepdim=True))
        total = total + ((gx(d) * wx).abs().mean() + (gy(d) * wy).abs().mean()) / 2 ** i
    return SMOOTH_WEIGHT * total / len(inv_depths)


def self_supervised_loss(image, context, inv_depths, K, poses):
    """The photometric loss over 4 scales (min over the warped contexts and
    the unwarped ones, the automask) plus the smoothness."""
    h_full, w_full = image.shape[1:3]
    scales = []
    images = []
    for inv in inv_depths:
        hs, ws = inv.shape[1:3]
        target = resize(image, (hs, ws))
        images.append(target)
        Ks = scale_intrinsics(K, ws / w_full)
        depth = 1.0 / inv.clamp(min=1e-6)
        maps = []
        for ctx, T in zip(context, poses):
            ref = resize(ctx, (hs, ws))
            maps.append(photometric_map(view_synthesis(ref, depth, Ks, T), target))
        for ctx in context:
            maps.append(photometric_map(resize(ctx, (hs, ws)), target))
        scales.append(torch.cat(maps, -1).min(-1).values.mean())
    return sum(scales) / len(scales) + smoothness(inv_depths, images)


def sparse_l1(inv_depths, gt_depth):
    """Mean over the scales of |pred - gt| on inverse depth where the
    ground truth is positive, the ground truth brought to each scale by
    nearest resize."""
    gt_inv = torch.where(gt_depth > 0, 1.0 / gt_depth.clamp(min=1e-6), torch.zeros_like(gt_depth))
    total = 0.0
    for pred in inv_depths:
        gt = resize(gt_inv, pred.shape[1:3], mode="nearest")
        mask = (gt > 0).to(pred.dtype)
        total = total + ((pred - gt).abs() * mask).sum() / mask.sum().clamp(min=1.0)
    return total / len(inv_depths)
