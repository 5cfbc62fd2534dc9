"""Row sharding of the depth network over the space axis of a (data x space)
process grid (``parallel/mesh.make_mesh_2d``): the counterpart of what
XLA's SPMD partitioner does for the JAX package's ``P('data', 'space')``
batches, written out.

Each rank of a space group holds one horizontal band of the rows of its
data rank's samples: at a level of the network whose tensors have h rows
a rank, rank s holds the global rows [s*h, (s+1)*h) of h*S. Every band is
as high as the others at every level, so a band needs no bookkeeping
beyond the group, its index and the count (``Band``): the global height and
the row start at any level follow from the local h.

An op that reads across a band edge takes its missing rows from the
neighbouring bands first (``halo``, differentiable: its backward sends the
halo's gradient to the band that owns the rows and adds it there), then
runs with no padding along H: zeros, -inf or the reflection are padded at
the global top and bottom only. The band-aware ops: ``conv2d`` (any k,
stride 1 or 2; without a padded copy of the band, ``_BandConv2d``),
``max_pool3s2``, ``reflect_pad_rows``, ``group_norm`` (statistics summed
over the space group), ``take_rows`` (any global rows a band reads, as the
band resizes of ``ops/image.interpolate_image`` and the NRS projection's
ray slab do), and the loss helpers ``mean`` (a mean over the global pixel
count), ``share`` (a loss computed from sums over a group, for the
supervised methods) and ``max_over``. The port's modules call them when a
band is in effect (``use``): ``nn/layers.Conv2d`` and ``FastGroupNorm``,
``ops/fold_conv.channel_conv3d`` / ``conv2d_same``, the ResNet's max pool
and reflection pads, SSIM, the smoothness term, the supervised loss and
``geometry/camera_generic.generic_project``.

The exchanges run over the space group with ``all_gather``: each rank
sends the rows its neighbours need, and takes its halo from theirs. A
band shallower than the halo (the deepest level of a small image) gathers
the whole tensor instead. Every rank issues its exchanges in the order of
the network's ops, forward and backward, which is the same on every rank;
under ``torch.utils.checkpoint`` the recomputed forward enters the band
again (``nn/packnet.PackNetBase._run``) and issues the same exchanges in
the same order.

``collectives`` counts this module's all-gathers (the exchanges, forward
and backward) and all-reduces (the group norm's statistics and its
backward's sums; ``sum_over`` and ``max_over``) since ``reset_counts``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

PAD_MODES = ("zeros", "reflect", "neg_inf")
collectives = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for key in collectives:
        collectives[key] = 0


def _all_reduce(t: torch.Tensor, group) -> None:
    collectives["all_reduce"] += 1
    dist.all_reduce(t, group=group)


@dataclasses.dataclass(frozen=True)
class Band:
    """This rank's band: ``index`` of ``count`` bands of the space
    ``group``."""

    group: object
    index: int
    count: int

    def start(self, h: int) -> int:
        """The global row of this band's first row, at a level of h rows a band."""
        return self.index * h

    def rows(self, h: int) -> int:
        """The global height at a level of h rows a band."""
        return self.count * h

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This band's rows of a whole tensor ``x`` (rows on ``dim``)."""
        h = x.shape[dim] // self.count
        return x.narrow(dim, self.index * h, h)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1


_current: list = []       # the band in effect (a stack; empty: whole tensors)


def current() -> Optional[Band]:
    """The band in effect, or None."""
    return _current[-1] if _current else None


@contextlib.contextmanager
def use(band: Optional[Band]):
    """Run the port's modules on ``band`` (None: on whole tensors)."""
    _current.append(band)
    try:
        yield band
    finally:
        _current.pop()


def check_rows(height: int, count: int, stride: int) -> None:
    """Refuse a height that does not split into ``count`` bands of a
    multiple of the network's total ``stride`` each: the deepest level
    would have a band of less than one row. (The JAX package's
    ``shard_batch`` leaves such a batch unsharded instead, silently.)"""
    if height % (count * stride):
        raise ValueError(
            f"image height {height} does not split into {count} bands of a multiple of the "
            f"depth network's stride {stride}: it must be divisible by {count} x {stride} = "
            f"{count * stride}")


def network_stride(depth_net) -> int:
    """The total stride of a depth network that runs on bands (its
    ``space_stride``); other networks are refused."""
    stride = getattr(depth_net, "space_stride", None)
    if stride is None:
        raise ValueError(f"{type(depth_net).__name__} does not run on a space axis: "
                         "PackNet01, PackNetSlim01, DepthResNet and RaySurfaceResNet do")
    return stride


def _gather(t: torch.Tensor, group) -> list:
    collectives["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _edge_pad(x: torch.Tensor, n: int, mode: str, top: bool, dim: int) -> torch.Tensor:
    """The n rows padded above (``top``) or below ``x`` at a global edge."""
    if mode == "reflect":
        h = x.shape[dim]
        rows = x.narrow(dim, 1, n) if top else x.narrow(dim, h - 1 - n, n)
        return rows.flip(dim)
    shape = list(x.shape)
    shape[dim] = n
    fill = float("-inf") if mode == "neg_inf" else 0.0
    return x.new_full(shape, fill)


def _edge_pad_grad(g: torch.Tensor, dx: torch.Tensor, n: int, top: bool, dim: int) -> None:
    """Add the gradient of a reflected edge pad ``g`` (n rows) to dx."""
    h = dx.shape[dim]
    rows = dx.narrow(dim, 1, n) if top else dx.narrow(dim, h - 1 - n, n)
    rows += g.flip(dim)


def _exchange(x, top, bottom, mode, dim, band):
    """(above, below): the ``top`` rows above this band and the ``bottom``
    rows below it, from the neighbouring bands, or padded by ``mode`` at
    the global edges. Each band sends the rows its neighbours need."""
    h = x.shape[dim]
    parts = _gather(torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, h - top, top)], dim),
                    band.group)
    above = (_edge_pad(x, top, mode, True, dim) if band.first
             else parts[band.index - 1].narrow(dim, bottom, top))
    below = (_edge_pad(x, bottom, mode, False, dim) if band.last
             else parts[band.index + 1].narrow(dim, 0, bottom))
    return above, below


def _exchange_grad(dx, g_above, g_below, mode, dim, band) -> None:
    """The transpose of ``_exchange``: add to dx (this band's gradient) the
    gradients of the rows that its neighbours took from it, sent back by
    them, and of its own rows reflected at a global edge."""
    top, bottom, h = g_above.shape[dim], g_below.shape[dim], dx.shape[dim]
    parts = _gather(torch.cat([g_above, g_below], dim), band.group)
    if not band.last:            # the band below took my last rows as its top halo
        dx.narrow(dim, h - top, top).add_(parts[band.index + 1].narrow(dim, 0, top))
    elif mode == "reflect":
        _edge_pad_grad(g_below, dx, bottom, False, dim)
    if not band.first:           # the band above took my first rows as its bottom halo
        dx.narrow(dim, 0, bottom).add_(parts[band.index - 1].narrow(dim, top, bottom))
    elif mode == "reflect":
        _edge_pad_grad(g_above, dx, top, True, dim)


class _Halo(torch.autograd.Function):
    """x [..., h, ...] (rows on ``dim``) -> [..., top + h + bottom, ...]:
    this band's rows with ``top`` rows of the bands above and ``bottom``
    of those below, padded by ``mode`` at the global edges."""

    @staticmethod
    def forward(ctx, x, top, bottom, mode, dim, band):
        ctx.args = (top, bottom, mode, dim, band)
        if top >= x.shape[dim] or bottom >= x.shape[dim]:
            return _halo_whole(x, top, bottom, mode, dim, band)
        above, below = _exchange(x, top, bottom, mode, dim, band)
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, mode, dim, band = ctx.args
        h = grad.shape[dim] - top - bottom
        if top >= h or bottom >= h:
            dx = _halo_whole_grad(grad, top, bottom, mode, dim, band)
        else:
            dx = grad.narrow(dim, top, h).clone(memory_format=torch.contiguous_format)
            _exchange_grad(dx, grad.narrow(dim, 0, top), grad.narrow(dim, top + h, bottom),
                           mode, dim, band)
        return dx, None, None, None, None, None


def _halo_whole(x, top, bottom, mode, dim, band):
    """The halo of a band shallower than it: gather every band, pad the
    whole tensor, take this band's window."""
    whole = torch.cat(_gather(x, band.group), dim)
    padded = torch.cat([_edge_pad(whole, top, mode, True, dim), whole,
                        _edge_pad(whole, bottom, mode, False, dim)], dim)
    h = x.shape[dim]
    return padded.narrow(dim, band.index * h, h + top + bottom)


def _halo_whole_grad(grad, top, bottom, mode, dim, band):
    """The transpose of ``_halo_whole``: every band's window gradient summed
    into the padded whole, the pads folded back, this band's rows taken."""
    h = grad.shape[dim] - top - bottom
    n = band.count * h
    shape = list(grad.shape)
    shape[dim] = n + top + bottom
    padded = grad.new_zeros(shape)
    for r, part in enumerate(_gather(grad, band.group)):
        padded.narrow(dim, r * h, h + top + bottom).add_(part)
    whole = padded.narrow(dim, top, n).clone()
    if mode == "reflect":
        _edge_pad_grad(padded.narrow(dim, 0, top), whole, top, True, dim)
        _edge_pad_grad(padded.narrow(dim, top + n, bottom), whole, bottom, False, dim)
    return whole.narrow(dim, band.index * h, h).contiguous()


def take_rows(x: torch.Tensor, bounds, dim: int = 2,
              band: Optional[Band] = None) -> torch.Tensor:
    """The global rows [start, stop) = ``bounds(band.index)`` of a band
    ``x`` (rows on ``dim``), from this band and its neighbours
    (differentiable). ``bounds(i)`` gives them for every band i: the halo
    is as deep as the farthest reach of any band, so that every rank
    exchanges alike (deeper than a band, the whole tensor is gathered).
    Rows outside the image must not be asked for."""
    band = band or current()
    h = x.shape[dim]
    reach = [bounds(i) for i in range(band.count)]
    top = max(max(i * h - a, 0) for i, (a, _) in enumerate(reach))
    bottom = max(max(b - (i + 1) * h, 0) for i, (_, b) in enumerate(reach))
    start, stop = reach[band.index]
    return halo(x, top, bottom, "zeros", dim, band).narrow(
        dim, start - band.start(h) + top, stop - start)


def halo(x: torch.Tensor, top: int, bottom: int, mode: str = "zeros", dim: int = 2,
         band: Optional[Band] = None) -> torch.Tensor:
    """``x`` (a band, rows on ``dim``) with ``top`` rows of the bands above
    and ``bottom`` of the bands below; at the global top and bottom, zeros,
    -inf (``'neg_inf'``) or the reflection (``'reflect'``). ``band``
    defaults to the one in effect."""
    if mode not in PAD_MODES:
        raise ValueError(f"halo mode must be one of {PAD_MODES}, got {mode!r}")
    band = band or current()
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, mode, dim, band)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _edge_rows(h: int, k: int, stride: int, pad: int):
    """Of a convolution's h // stride output rows on a band of h rows:
    (the first ``n_top`` rows whose window reaches above the band, the
    first row ``j_bot`` whose window reaches below it)."""
    return -(-pad // stride), (h - k + pad) // stride + 1


def _slab_convs():
    """cuDNN off, its other settings kept: for the convolutions of the edge
    slabs, a few rows high and as wide and deep as the band, cuDNN picked
    algorithms with workspaces of a gigabyte and float32 weight gradients
    3.6e-4 of their largest apart (measured on an H100, PackNet01's first
    pack layer at 384x1280); PyTorch's own convolution (unfold and a
    matrix product) takes neither."""
    c = torch.backends.cudnn
    return c.flags(enabled=False, benchmark=c.benchmark, deterministic=c.deterministic,
                   allow_tf32=c.allow_tf32)


class _BandConv2d(torch.autograd.Function):
    """``F.conv2d`` of an NCHW band with zero padding, without a padded copy
    of the band: the convolution runs on the band as it is, zero-padded as
    if it were the whole image, and the output rows whose window reaches
    across an edge are computed again from a slab of the band's edge rows
    and the neighbours' rows (``_slab_convs``), and written over. The
    backward does the same in reverse: the interior's gradient from the one
    convolution, the slabs' from theirs, their halo rows' sent back to
    their bands."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups, band):
        (sh, _), (ph, pw) = stride, padding
        h, k = x.shape[2], weight.shape[2]
        n_top, j_bot = _edge_rows(h, k, sh, ph)
        above, below = _exchange(x, ph, ph, "zeros", 2, band)
        y = F.conv2d(x, weight, bias, stride, padding, 1, groups)
        top_in = sh * (n_top - 1) + k - ph          # the band's rows that the top slab takes
        with _slab_convs():
            y[:, :, :n_top] = F.conv2d(torch.cat([above, x[:, :, :top_in]], 2), weight, bias,
                                       stride, (0, pw), 1, groups)
            if j_bot < y.shape[2]:
                start = sh * j_bot - ph             # the band's rows from here on
                slab = torch.cat([x[:, :, start:], below[:, :, :sh * (y.shape[2] - j_bot - 1)
                                                            + k - (h - start)]], 2)
                y[:, :, j_bot:] = F.conv2d(slab, weight, bias, stride, (0, pw), 1, groups)
        ctx.save_for_backward(x, weight, above, below)
        ctx.args = (stride, padding, groups, band, bias is not None, n_top, j_bot, top_in)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, above, below = ctx.saved_tensors
        stride, padding, groups, band, has_bias, n_top, j_bot, top_in = ctx.args
        (sh, _), (ph, pw) = stride, padding
        h, k, h_out = x.shape[2], weight.shape[2], gy.shape[2]

        def conv_grads(g, inp, pad):
            with contextlib.nullcontext() if pad is padding else _slab_convs():
                return torch.ops.aten.convolution_backward(
                    g.contiguous(), inp, weight, [weight.shape[0]] if has_bias else None,
                    stride, pad, [1, 1], False, [0, 0], groups, [True, True, has_bias])

        g_mid = gy.clone()
        g_mid[:, :, :n_top] = 0
        g_mid[:, :, j_bot:] = 0
        dx, dw, db = conv_grads(g_mid, x, padding)
        d_slab, dw_e, db_e = conv_grads(gy[:, :, :n_top], torch.cat([above, x[:, :, :top_in]], 2),
                                        [0, pw])
        dw = dw + dw_e
        db = db + db_e if has_bias else None
        d_above = d_slab[:, :, :ph]
        dx[:, :, :top_in] += d_slab[:, :, ph:]
        d_below = torch.zeros_like(below)
        if j_bot < h_out:
            start = sh * j_bot - ph
            n_below = sh * (h_out - j_bot - 1) + k - (h - start)
            d_slab, dw_e, db_e = conv_grads(
                gy[:, :, j_bot:], torch.cat([x[:, :, start:], below[:, :, :n_below]], 2), [0, pw])
            dw = dw + dw_e
            db = db + db_e if has_bias else None
            dx[:, :, start:] += d_slab[:, :, :h - start]
            d_below[:, :, :n_below] = d_slab[:, :, h - start:]
        _exchange_grad(dx, d_above, d_below, "zeros", 2, band)
        return dx, dw, db, None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride=1,
           padding=0, groups: int = 1, band: Optional[Band] = None) -> torch.Tensor:
    """``F.conv2d`` of an NCHW band with zero padding: the rows the kernel
    reads across the band's edges come from the neighbouring bands
    (``_BandConv2d``; a band shallower than its kernel's reach takes the
    padded copy of ``halo`` instead). A stride s needs the band's global
    row start to be a multiple of s."""
    band = band or current()
    stride, padding = _pair(stride), _pair(padding)
    (sh, _), (ph, pw) = stride, padding
    h, k = x.shape[2], weight.shape[2]
    if band.start(h) % sh:
        raise ValueError(f"a stride-{sh} convolution on a band starting at row {band.start(h)}")
    n_top, j_bot = _edge_rows(h, k, sh, ph)
    if ph < h and sh * (n_top - 1) + k - ph <= h and n_top <= j_bot and sh * j_bot >= ph:
        return _BandConv2d.apply(x, weight, bias, stride, padding, groups, band)
    return F.conv2d(halo(x, ph, ph, "zeros", 2, band), weight, bias, stride, (0, pw),
                    groups=groups)


def max_pool3s2(x: torch.Tensor, band: Optional[Band] = None) -> torch.Tensor:
    """``F.max_pool2d(x, 3, stride=2, padding=1)`` of an NCHW band."""
    band = band or current()
    return F.max_pool2d(halo(x, 1, 1, "neg_inf", 2, band), 3, stride=2, padding=(0, 1))


def reflect_pad_rows(x: torch.Tensor, n: int = 1, dim: int = 2,
                     band: Optional[Band] = None) -> torch.Tensor:
    """Pad the rows of a band by ``n`` with the neighbours' rows, and with
    the reflection at the global top and bottom."""
    return halo(x, n, n, "reflect", dim, band or current())


class _BandGroupNorm(torch.autograd.Function):
    """GroupNorm of an NCHW band over the whole image: the per-sample,
    per-group mean and (biased) variance summed over the space group, in two
    passes, in float32. It keeps what ``F.group_norm`` keeps for its
    backward (the input and the statistics), and its backward reduces the
    two sums that the input's gradient needs in one exchange."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, band):
        b = x.shape[0]
        g = x.float().reshape(b, num_groups, -1)
        n = g.shape[-1] * band.count
        total = g.sum(-1)
        _all_reduce(total, band.group)
        mean = (total / n)[..., None]
        centered = g - mean
        sq = (centered * centered).sum(-1)
        _all_reduce(sq, band.group)
        rstd = torch.rsqrt(sq / n + eps)[..., None]
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.args = (num_groups, n, band)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (centered * rstd).reshape(x.shape) * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        num_groups, n, band = ctx.args
        b = x.shape[0]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = (0,) + tuple(range(2, x.dim()))
        xhat = (x.float().reshape(b, num_groups, -1) - mean) * rstd
        dy = dy.float()
        d_weight = (dy * xhat.reshape(x.shape)).sum(dims)
        d_bias = dy.sum(dims)
        d_xhat = (dy * weight.view(shape)).reshape(b, num_groups, -1)
        sums = torch.stack([d_xhat.sum(-1), (d_xhat * xhat).sum(-1)])
        _all_reduce(sums, band.group)
        dx = rstd * (d_xhat - sums[0][..., None] / n - xhat * (sums[1][..., None] / n))
        return dx.reshape(x.shape).to(x.dtype), d_weight, d_bias, None, None, None


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, band: Optional[Band] = None) -> torch.Tensor:
    """``F.group_norm`` of an NCHW band in float32: the per-sample, per-group
    mean and (biased) variance of the whole image (``_BandGroupNorm``)."""
    return _BandGroupNorm.apply(x, weight, bias, num_groups, eps, band or current())


def mean(x: torch.Tensor, band: Optional[Band]) -> torch.Tensor:
    """This band's share of the mean of the whole tensor: its sum over the
    global element count (the shares sum to the mean over the space
    group). No band: ``x.mean()``."""
    if band is None:
        return x.mean()
    return x.sum() / (x.numel() * band.count)


def share(loss_fn, sums: torch.Tensor, group, band: Optional[Band]) -> torch.Tensor:
    """This rank's share of a loss that needs sums over the whole batch:
    ``loss_fn`` of ``sums`` (this rank's, stacked) summed over ``group``
    (None: this rank's are the whole), divided by the band count. Every
    rank of a space group computes the whole loss; the backward of the sum
    gives each rank's sums the gradient of every rank's share, which the
    train step's scale by the band count and DDP's mean make the whole
    loss's gradient."""
    if group is not None:
        from packnet_sfm_tpu_torch.parallel.mesh import all_reduce_sum

        sums = all_reduce_sum(sums, group)
    loss = loss_fn(sums)
    return loss if band is None else loss / band.count


def max_over(t: torch.Tensor, group) -> torch.Tensor:
    """The largest value of ``t`` over the ranks of ``group`` (None: this
    rank's), detached: a threshold that no gradient flows through."""
    t = t.detach().amax()
    if group is None:
        return t
    t = t.clone()
    collectives["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def sum_over(values: dict, band: Optional[Band]) -> dict:
    """Each tensor of ``values`` summed over the space group (detached): the
    bands' shares -> the whole. No band: ``values``."""
    if band is None:
        return values
    out = {}
    for k, v in values.items():
        t = v.detach().clone()
        _all_reduce(t, band.group)
        out[k] = t
    return out
