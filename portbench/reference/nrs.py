"""Plain PyTorch Neural Ray Surfaces (NRS): the network, the ray-surface
camera and the training loss of TRI-ML/packnet-sfm's ``train_omnicam.yaml``
(GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet), from Vasiljevic,
Guizilini et al., "Neural Ray Surfaces for Self-Supervised Learning of
Depth and Ego-motion" (3DV 2020), and the upstream code's
``networks/layers/resnet``, ``geometry/camera_generic.py`` and
``losses/generic_multiview_photometric_loss.py``.

- The network: a ResNet-18 encoder (BatchNorm in training mode: the batch's
  statistics, the biased variance), the monodepth2 depth decoder (sigmoid
  disparities at 4 scales, scaled to inverse depth between 1/100 and 1/0.1)
  and the ray-surface decoder (the same trunk, a tanh 3-channel head at
  full resolution). Its input is normalised as (x - 0.45) / 0.225.
- The camera: each pixel's ray is the canonical template plus the decoded
  residual times min((100 p)^(4/3) / 100, 1) at training progress p,
  unit-normalised; a point is its ray times its depth. A point seen from the
  context camera is projected by a soft-argmax over the dot products of its
  direction with the rays of a (2 patch + 1)^2 window, at half resolution
  (both fields resized bilinearly with aligned corners), at temperature
  1e-4 / exp(0.1 p); the window of pixel (y, x) starts at clamp(y - patch,
  0, h - k), clamp(x - patch, 0, w - k). The coordinates are resized back
  and the context warped at them (bilinear, zeros outside).
- The loss: L1 + SSIM (0.85) of each warped context against the target,
  clipped at the map's mean + 0.5 std, the mean over pixels and then over
  the contexts (no automask, one scale), plus 0.1 times the edge-aware
  smoothness of the mean-normalised inverse depth.

Departures, each also the program's:
- The canonical template is a centred 90-degree pinhole's unit rays,
  (x - (W - 1) / 2, y - (H - 1) / 2, W / 2) normalised, built in float64:
  upstream loads ``omnicam_ray_template.npy``, which its repository does
  not hold.
- The soft-argmax runs in chunks of rows, each recomputed in the backward
  (``torch.utils.checkpoint``), so that the float64 windows of a whole
  batch fit the card; the arithmetic is the dense window's.
- PoseNet is the one of ``nets.py`` (7 stride-2 conv + GroupNorm(16) +
  ReLU stages, 0.01 * the mean of a 1x1 head), as the recipe names it.

Parameter names follow the program's state dict, so that both sides take
the same weights from the benchmark's draw (``portbench/weights.py``).
Every convolution is a ``nets.Conv2d``, so that ``nets.set_precision``
rounds them all for the control. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from portbench.reference.losses import photometric_map, pose_vec_to_mat, resize
from portbench.reference.nets import Conv2d, PoseNet

PATCH = 20
CLIP = 0.5
SMOOTH_WEIGHT = 0.1
# rows of the half-resolution image that one soft-argmax chunk takes
ROW_CHUNK = 4


# ---- the network -----------------------------------------------------------

class BatchNorm(nn.Module):
    """Training-mode batch norm: the batch's mean and biased variance."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, 1e-5)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, c, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(c)
        self.conv2 = Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(c)
        self.downsample = stride != 1 or cin != c
        if self.downsample:
            self.downsample_conv = Conv2d(cin, c, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(c)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        skip = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + skip)


class ResNet18Encoder(nn.Module):
    """NCHW image -> 5 features at strides 2-32, 64-64-128-256-512 channels."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, width in enumerate((64, 128, 256, 512)):
            for bi in range(2):
                stride = 2 if li > 0 and bi == 0 else 1
                self.add_module(f"layer{li + 1}_{bi}", BasicBlock(cin, width, stride))
                cin = width

    def forward(self, x):
        f0 = F.relu(self.bn1(self.conv1((x - 0.45) / 0.225)))
        x = F.max_pool2d(f0, 3, stride=2, padding=1)
        feats = [f0]
        for li in range(4):
            for bi in range(2):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            feats.append(x)
        return feats


class ReflConv(nn.Module):
    """3x3 convolution of the reflection-padded input, ELU after it or not."""

    def __init__(self, cin: int, c: int, elu: bool):
        super().__init__()
        self.conv = Conv2d(cin, c, 3)
        self.elu = elu

    def forward(self, x):
        y = self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        return F.elu(y) if self.elu else y


class Decoder(nn.Module):
    """The monodepth2 decoder over the encoder's features: at each level a
    conv, a nearest upsampling by 2, the skip, a conv. ``heads``: sigmoid
    disparity heads at the 4 finest levels (finest first); otherwise a tanh
    3-channel ray-surface head at full resolution."""

    CHANNELS = (16, 32, 64, 128, 256)
    ENCODER = (64, 64, 128, 256, 512)

    def __init__(self, heads: bool):
        super().__init__()
        self.heads = heads
        cin = self.ENCODER[-1]
        for i in range(4, -1, -1):
            c = self.CHANNELS[i]
            self.add_module(f"upconv_{i}_0", ReflConv(cin, c, True))
            skip = self.ENCODER[i - 1] if i > 0 else 0
            self.add_module(f"upconv_{i}_1", ReflConv(c + skip, c, True))
            if heads and i < 4:
                self.add_module(f"dispconv_{i}", ReflConv(c, 1, False))
            cin = c
        if not heads:
            self.raysurfconv_0 = ReflConv(self.CHANNELS[0], 3, False)

    def forward(self, feats):
        x, disps = feats[-1], {}
        for i in range(4, -1, -1):
            x = F.interpolate(getattr(self, f"upconv_{i}_0")(x), scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if self.heads and i < 4:
                disps[i] = torch.sigmoid(getattr(self, f"dispconv_{i}")(x))
        if self.heads:
            return [disps[i] for i in range(4)]
        return torch.tanh(self.raysurfconv_0(x))


class RaySurfaceResNet18(nn.Module):
    """NHWC rgb -> {'inv_depths': 4 NHWC scales, finest first, 'ray_surface':
    the NHWC residual}."""

    MIN_DEPTH, MAX_DEPTH = 0.1, 100.0

    def __init__(self):
        super().__init__()
        self.encoder = ResNet18Encoder()
        self.decoder = Decoder(heads=True)
        self.ray_decoder = Decoder(heads=False)

    def forward(self, rgb):
        feats = self.encoder(rgb.permute(0, 3, 1, 2))
        lo, hi = 1.0 / self.MAX_DEPTH, 1.0 / self.MIN_DEPTH
        inv = [(lo + (hi - lo) * d).permute(0, 2, 3, 1) for d in self.decoder(feats)]
        return {"inv_depths": inv, "ray_surface": self.ray_decoder(feats).permute(0, 2, 3, 1)}


def build() -> nn.ModuleDict:
    """The NRS networks, named as the program's ``SfmModelDef`` names them."""
    return nn.ModuleDict({"depth_net": RaySurfaceResNet18(), "pose_net": PoseNet()})


# ---- the ray-surface camera ---------------------------------------------------

def template(h: int, w: int, device, dtype) -> torch.Tensor:
    """The canonical unit rays [H, W, 3] of a centred 90-degree pinhole."""
    f = 0.5 * w / math.tan(math.radians(90.0) / 2)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    rays = torch.stack([(xs - (w - 1) / 2) / f, (ys - (h - 1) / 2) / f, torch.ones_like(xs)], -1)
    return (rays / rays.norm(dim=-1, keepdim=True)).to(dtype)


def blend(canonical, residual, progress: float):
    """The template plus the annealed residual, unit-normalised: [B, H, W, 3]."""
    coeff = min((100.0 * progress) ** (4.0 / 3.0) / 100.0, 1.0)
    rays = canonical[None] + coeff * residual
    return rays / rays.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def temperature(progress: float) -> float:
    return 1e-4 / math.exp(0.1 * progress)


def _window_starts(n: int, patch: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) - patch).clamp(0, n - (2 * patch + 1))


def _softargmax_rows(direction, rays, rows, temp: float, patch: int):
    """(ex, ey) [B, r, w] of the direction rows ``rows`` [r] of
    ``direction`` [B, h, w, 3] against ``rays`` [B, h, w, 3]."""
    h, w = rays.shape[1:3]
    k = 2 * patch + 1
    kk = torch.arange(k, device=rays.device)
    sy = _window_starts(h, patch, rays.device)[rows]                    # [r]
    sx = _window_starts(w, patch, rays.device)                          # [w]
    win = rays[:, sy[:, None] + kk][:, :, :, sx[:, None] + kk]          # [B, r, k, w, k, 3]
    logits = torch.einsum("brxc,brixjc->brxij", direction[:, rows], win) / temp
    prob = torch.softmax(logits.flatten(3), -1).view(logits.shape)      # [B, r, w, k, k]
    offs = kk.to(rays.dtype)
    ey = prob.sum(4) @ offs + sy.to(rays.dtype)[None, :, None]
    ex = prob.sum(3) @ offs + sx.to(rays.dtype)[None, None, :]
    return ex, ey


def softargmax(direction, rays, temp: float, patch: int = PATCH, checkpoint: bool = True):
    """Expected window coordinates (ex, ey) [B, h, w] of each direction
    [B, h, w, 3] among the rays [B, h, w, 3] of its window; in chunks of
    ``ROW_CHUNK`` rows, each recomputed in the backward where
    ``checkpoint``."""
    h = direction.shape[1]
    exs, eys = [], []
    for r0 in range(0, h, ROW_CHUNK):
        rows = torch.arange(r0, min(r0 + ROW_CHUNK, h), device=direction.device)
        if checkpoint:
            ex, ey = torch.utils.checkpoint.checkpoint(
                _softargmax_rows, direction, rays, rows, temp, patch, use_reentrant=False)
        else:
            ex, ey = _softargmax_rows(direction, rays, rows, temp, patch)
        exs.append(ex)
        eys.append(ey)
    return torch.cat(exs, 1), torch.cat(eys, 1)


def project(rays, points, pose, temp: float, patch: int = PATCH, checkpoint: bool = True):
    """Normalised coordinates [B, H, W, 2] (aligned corners) at which the
    camera of ``rays`` [B, H, W, 3] sees the target's ``points`` [B, H, W,
    3] moved by ``pose`` [B, 4, 4] (target to that camera)."""
    b, H, W, _ = points.shape
    pts = torch.einsum("bij,bhwj->bhwi", pose[:, :3, :3], points) + pose[:, None, None, :3, 3]
    h, w = H // 2, W // 2
    pts, rays = resize(pts, (h, w)), resize(rays, (h, w))
    direction = pts / pts.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    ex, ey = softargmax(direction, rays, temp, patch, checkpoint)
    coords = torch.stack([2.0 * ex / (w - 1) - 1.0, 2.0 * ey / (h - 1) - 1.0], -1)
    return resize(coords, (H, W))


def warp(image, coords):
    """``image`` [B, H, W, C] sampled at ``coords`` [B, H, W, 2]: bilinear,
    aligned corners, zeros outside."""
    out = F.grid_sample(image.permute(0, 3, 1, 2), coords, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


# ---- the loss ---------------------------------------------------------------

def clipped(photo):
    """The photometric map clipped at its mean + CLIP std (over the batch)."""
    return torch.minimum(photo, photo.mean() + CLIP * photo.std(correction=0))


def smoothness(inv, image):
    """Edge-aware smoothness of the mean-normalised inverse depth [B, H, W,
    1] against ``image`` [B, H, W, 3], times its weight."""
    d = inv / inv.mean(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    gx = lambda t: t[:, :, :-1] - t[:, :, 1:]      # noqa: E731
    gy = lambda t: t[:, :-1] - t[:, 1:]            # noqa: E731
    wx = torch.exp(-gx(image).abs().mean(-1, keepdim=True))
    wy = torch.exp(-gy(image).abs().mean(-1, keepdim=True))
    return SMOOTH_WEIGHT * ((gx(d) * wx).abs().mean() + (gy(d) * wy).abs().mean())


def train_loss(nets: Dict, batch: Dict, progress: float,
               checkpoint: bool = True) -> torch.Tensor:
    """The NRS training loss of a prepared batch ('rgb', 'context' the
    networks' inputs; 'rgb_original', 'context_original' the loss's)."""
    out = nets["depth_net"](batch["rgb"])
    vec = nets["pose_net"](batch["rgb"], batch["context"])
    poses = [pose_vec_to_mat(vec[:, i]) for i in range(vec.shape[1])]
    image = batch["rgb_original"]
    h, w = image.shape[1:3]
    rays = blend(template(h, w, image.device, image.dtype), out["ray_surface"], progress)
    inv = out["inv_depths"][0]
    points = rays * (1.0 / inv.clamp(min=1e-6))
    temp = temperature(progress)
    photo: List[torch.Tensor] = []
    for ctx, pose in zip(batch["context_original"], poses):
        xy = project(rays, points, pose, temp, checkpoint=checkpoint)
        photo.append(clipped(photometric_map(warp(ctx, xy), image)).mean())
    return sum(photo) / len(photo) + smoothness(inv, image)
