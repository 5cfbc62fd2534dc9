"""The sparse lidar branch of PackNet-SAN in its dense masked form (port of
``nn/sparse.py``). The reference runs MinkowskiEngine's sparse
convolutions; the JAX package, and this port, express the same math
densely on a 2D depth map, with the active sites as a validity mask:

- a sparse conv (the sum over active neighbours, output on active sites)
  is a dense conv over ``features * mask``, re-masked;
- sparse batch norm takes its statistics over the active sites only;
- sparse max pooling (3, stride 2) is a max over the valid entries of each
  window, whose new mask is "any entry valid";
- densifying is a no-op: inactive sites are zero by construction.

Modules take and return NCHW tensors (a mask has one channel). The convs
are cuDNN convolutions on masked input, in float32: the encoder takes no
dtype and upcasts its input depth, so a bfloat16 depth is computed on in
float32 as the JAX package's dtype-less layers would compute it. (The JAX
package itself cannot take one: its pool runs ``reduce_window`` with a
float32 initial value on the bfloat16 mask and raises, ROADMAP.md §3 (m).) Submodules are
named after the flax tree (``block<i>``, ``l1_conv0`` ... ``final_bn``,
``conv`` for ``Conv_0``), so ``utils/convert.from_jax`` maps the weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from packnet_sfm_tpu_torch.nn.layers import Conv2d
from packnet_sfm_tpu_torch.parallel.mesh import all_reduce_sum, batch_group


def sparsify_depth(depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth [B, 1, H, W] -> (features, mask): the mask of depth > 0, in the
    depth's dtype, and the depth on it."""
    mask = (depth > 0).to(depth.dtype)
    return depth * mask, mask


def masked_max_pool(x: torch.Tensor, mask: torch.Tensor, window: int = 3,
                    stride: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max over the valid entries of each window (zero where none is), and
    the new mask: any entry of the window valid. Invalid entries take the
    dtype's lowest finite value, as the JAX package fills them."""
    p = window // 2
    xm = torch.where(mask > 0, x, torch.finfo(x.dtype).min)
    pooled = F.max_pool2d(xm, window, stride, p)
    new_mask = F.max_pool2d(mask, window, stride, p)
    return torch.where(new_mask > 0, pooled, 0.0), new_mask


class MaskedBatchNorm(nn.Module):
    """Batch norm whose statistics are taken over the active sites only
    (MinkowskiBatchNorm), momentum 0.9 and eps 1e-5 as flax writes them,
    the running variance moved towards the BIASED batch variance. The
    output is re-masked. With more than one rank the active sites are those
    of the global batch: the count and both sums go over every rank
    (``parallel/mesh.all_reduce_sum``, whose gradients cross the ranks), as
    the JAX package takes them over its jit's whole batch. Parameters
    ``weight``/``bias`` (flax ``scale``/``bias``), buffers
    ``running_mean``/``running_var`` (flax ``mean``/``var``)."""

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            group = batch_group()

            def total(t):
                return t if group is None else all_reduce_sum(t, group)

            n = torch.clamp(total(mask.sum()), min=1.0)
            dims = (0, 2, 3)
            mean = total((x * mask).sum(dims)) / n
            var = total(((x - mean.view(1, -1, 1, 1)) ** 2 * mask).sum(dims)) / n
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.float())
                self.running_var.mul_(m).add_((1.0 - m) * var.float())
        else:
            mean, var = self.running_mean, self.running_var
        out = (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var.view(1, -1, 1, 1) + self.epsilon)
        out = out * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return out * mask


class SparseConv(nn.Module):
    """One sparse conv: a dense conv (zero padding k // 2) over the masked
    features, the output re-masked."""

    def __init__(self, cin: int, features: int, kernel_size: int):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.conv(x * mask) * mask


class SparseConvBlock(nn.Module):
    """Three parallel sparse-conv paths (1, 2 and 3 convs, batch norm and
    ReLU between), summed, batch norm and ReLU; a stride-2 masked max pool
    first where ``stride`` != 1 (the reference's MinkConv2D, without its
    uncertainty head, which no config uses)."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 2):
        super().__init__()
        f, k = features, kernel_size
        self.stride = stride
        self.l1_conv0 = SparseConv(cin, f, k)
        self.l2_conv0 = SparseConv(cin, 2 * f, k)
        self.l2_bn0 = MaskedBatchNorm(2 * f)
        self.l2_conv1 = SparseConv(2 * f, f, k)
        self.l3_conv0 = SparseConv(cin, 2 * f, k)
        self.l3_bn0 = MaskedBatchNorm(2 * f)
        self.l3_conv1 = SparseConv(2 * f, 2 * f, k)
        self.l3_bn1 = MaskedBatchNorm(2 * f)
        self.l3_conv2 = SparseConv(2 * f, f, k)
        self.final_bn = MaskedBatchNorm(f)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        if self.stride != 1:
            x, mask = masked_max_pool(x, mask, 3, self.stride)

        def bn_relu(bn, t):
            return F.relu(bn(t, mask)) * mask

        x1 = self.l1_conv0(x, mask)
        x2 = bn_relu(self.l2_bn0, self.l2_conv0(x, mask))
        x2 = self.l2_conv1(x2, mask)
        x3 = bn_relu(self.l3_bn0, self.l3_conv0(x, mask))
        x3 = bn_relu(self.l3_bn1, self.l3_conv1(x3, mask))
        x3 = self.l3_conv2(x3, mask)
        return bn_relu(self.final_bn, x1 + x2 + x3), mask


class SparseDepthEncoder(nn.Module):
    """A cascade of SparseConvBlocks (stride 2 each, kernels 5, 5, 3, ...)
    over the sparse depth: one densified feature a level, [B, channels[i],
    H_i, W_i], in one pass (the reference's MinkowskiEncoder walk)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.channels = tuple(channels)
        kernel_sizes = [5, 5] + [3] * (len(self.channels) - 1)
        cin = 1
        for i, ch in enumerate(self.channels):
            self.add_module(f"block{i}", SparseConvBlock(cin, ch, kernel_sizes[i], 2))
            cin = ch

    def forward(self, input_depth: torch.Tensor) -> list:
        """input_depth [B, 1, H, W] (any float dtype, taken in float32) ->
        the features of every level."""
        feats, mask = sparsify_depth(input_depth.float())
        outputs = []
        for i in range(len(self.channels)):
            feats, mask = getattr(self, f"block{i}")(feats, mask)
            outputs.append(feats)
        return outputs
