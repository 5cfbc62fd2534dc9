"""One rank of tests/test_torch_spatial.py, launched by it with
``torch.distributed.run --standalone``; imports only the port, torch and
numpy.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_spatial_worker.py <data dir>

The test writes the starting weights, the batches and the configs into
<data dir>; each rank joins the gloo group on the CPU, builds the
(data x space) grid, runs the cases of its world size and writes what it
got to <data dir>/rank<r>_world<n>.pt.

Two ranks (data 1 x space 2):
- 'ops': every band-aware op on this rank's band against the same rows of
  the op on the whole tensor (each rank computes both): forward, input
  gradient and parameter gradients (summed over the space group), as the
  largest error relative to the whole op's largest value;
- 'packnet': one Adam step of PackNetSlim01-1A + PoseNet on the batch of 2
  (loss, state dict, the pack layers' modes); 'zero_pad': the same with
  every exchange's rows from the other bands replaced by zeros (the
  control);
- 'eval': the eval step's metric rows.

Four ranks (data 2 x space 2):
- 'resnet': one Adam step of DepthResNet-18 + PoseNet on this data rank's
  4 rows of the global batch of 8;
- 'refused': the error of a PackNetSlim01 step on a grid of space 4 at a
  height of 64, on every rank (None where none was raised).
"""

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.core.config import config_from_dict
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.metrics import DepthMetricsConfig
from packnet_sfm_tpu_torch.engine.train import make_eval_step, make_train_step, zero_metrics
from packnet_sfm_tpu_torch.losses.smoothness import smoothness_loss
from packnet_sfm_tpu_torch.nn.layers import Conv2d, FastGroupNorm
from packnet_sfm_tpu_torch.nn.packnet import ChannelConv3d
from packnet_sfm_tpu_torch.nn.resnet import ConvBlockRefl
from packnet_sfm_tpu_torch.ops import fold_conv
from packnet_sfm_tpu_torch.ops.fold_conv import fused_pack_conv, pack_conv_two_step
from packnet_sfm_tpu_torch.ops.ssim import ssim_loss
from packnet_sfm_tpu_torch.parallel import mesh, spatial
from tests.torch_distributed_worker import load_batch, rows

STEPS_PER_EPOCH = 1000


def _counting_pack_paths():
    """Wraps ``ops/fold_conv``'s two pack conv paths, which
    ``fused_pack_conv`` calls by their module names, with call counters;
    returns the counts and a function that puts the paths back."""
    paths = {"two_step": 0, "fused": 0}
    both = {"two_step": fold_conv.pack_conv_two_step, "fused": fold_conv.apply_fused_kernels}

    def counted(name):
        def call(*args, **kwargs):
            paths[name] += 1
            return both[name](*args, **kwargs)
        return call

    fold_conv.pack_conv_two_step = counted("two_step")
    fold_conv.apply_fused_kernels = counted("fused")

    def restore():
        fold_conv.pack_conv_two_step, fold_conv.apply_fused_kernels = both.values()
    return paths, restore


def train_step(cfg_dict, state0, batch, grid=None):
    """One Adam step from ``state0``: loss, metrics, state dict, and the
    calls of each pack conv path."""
    cfg = config_from_dict(cfg_dict)
    model = setup_model(cfg.model, device="cpu")
    model.load_state_dict(state0, strict=True)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                          STEPS_PER_EPOCH)
    step = make_train_step(model, optimizer, scheduler, mesh=grid)
    paths, restore = _counting_pack_paths()
    try:
        acc = step(zero_metrics("cpu"), batch, 0.0)
    finally:
        restore()
    return dict(loss=float(acc["loss"][0]),
                metrics={k: float(v[0]) for k, v in acc.items() if float(v[1]) > 0},
                state={k: v.clone() for k, v in model.state_dict().items()},
                pack_paths=paths)


def eval_rows(cfg_dict, state0, batch, grid=None):
    cfg = config_from_dict(cfg_dict)
    model = setup_model(cfg.model, device="cpu")
    model.load_state_dict(state0, strict=True)
    out = make_eval_step(model, DepthMetricsConfig(), mesh=grid)(batch)
    return {k: v.numpy() for k, v in out.items()}


# --- the ops --------------------------------------------------------------------------

def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _op_case(band, fn, x, params=(), dim=2, extra=None):
    """fn(x, extra) on the whole ``x`` and, under the band, on its rows
    (``extra`` whole on both, or cut to the band where it is a tensor to
    cut: ``('band', t)``). A cotangent drawn from a seed weights the
    outputs; a scalar output is a share, summed over the group."""
    def arg(band_mode):
        if extra is None:
            return None
        kind, t = extra
        return band.take(t, dim) if band_mode and kind == "band" else t

    for p in params:
        p.grad = None
    xw = x.clone().requires_grad_()
    yw = fn(xw, arg(False))
    g = torch.from_numpy(np.random.default_rng(11).standard_normal(tuple(yw.shape))
                         .astype(np.float32)) if yw.dim() else torch.ones(())
    (yw * g).sum().backward()
    dxw, dpw = xw.grad, [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    xb = band.take(x, dim).clone().requires_grad_()
    with spatial.use(band):
        yb = fn(xb, arg(True))
    if yw.dim():
        gb = band.take(g, dim)
        fwd = _rel(yb.detach(), band.take(yw.detach(), dim))
    else:
        gb = g
        total = yb.detach().clone()
        torch.distributed.all_reduce(total, group=band.group)
        fwd = _rel(total, yw.detach())
    (yb * gb).sum().backward()
    grads = [_rel(xb.grad, band.take(dxw, dim))]
    for p, want in zip(params, dpw):
        got = p.grad.clone()
        torch.distributed.all_reduce(got, group=band.group)
        grads.append(_rel(got, want))
    return dict(forward=fwd, input_grad=grads[0], param_grads=grads[1:])


def op_cases(band):
    rng = np.random.default_rng(7)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32))

    torch.manual_seed(0)
    out = {}

    def module(m, x, name, dim=2):
        out[name] = _op_case(band, lambda v, _: m(v), x, list(m.parameters()), dim)

    for k, s, cin in ((3, 1, 4), (3, 2, 4), (7, 1, 4), (7, 2, 3)):
        module(Conv2d(cin, 6, k, stride=s, padding=k // 2), t(2, cin, 16, 12),
               f"conv2d_k{k}_s{s}")
    # a band of 2 rows under a halo of 3: the whole-tensor gather
    module(Conv2d(4, 6, 7, padding=3), t(2, 4, 4, 12), "conv2d_k7_s1_shallow")
    module(ChannelConv3d(4), t(2, 8, 16, 12), "channel_conv3d")
    w3, b3 = t(4, 1, 3, 3, 3, scale=0.3), t(4, scale=0.1)
    w2, b2 = t(6, 32, 3, 3, scale=0.1), t(6, scale=0.1)
    params = [p.requires_grad_() for p in (w3, b3, w2, b2)]
    out["pack_conv_two_step"] = _op_case(
        band, lambda v, _: pack_conv_two_step(v, *params), t(2, 16, 12, 8), params, dim=1)
    # the fused path on the whole tensor; a band takes the two-step path
    out["fused_pack_conv"] = _op_case(
        band, lambda v, _: fused_pack_conv(v, *params, mode="fused"), t(2, 16, 12, 8), params,
        dim=1)
    out["max_pool3s2"] = _op_case(
        band, lambda v, _: spatial.max_pool3s2(v) if spatial.current() else
        F.max_pool2d(v, 3, stride=2, padding=1), t(2, 4, 16, 12))
    module(FastGroupNorm(32, 16), t(2, 32, 16, 12, scale=3.0, shift=5.0), "group_norm")
    module(ConvBlockRefl(4, 6), t(2, 4, 16, 12), "conv_block_refl")
    # a band of one row: the reflection at the global edge is the other band's row
    module(ConvBlockRefl(4, 6), t(2, 4, 2, 6), "conv_block_refl_shallow")
    y = torch.rand(2, 16, 12, 3, generator=torch.Generator().manual_seed(3))
    out["ssim"] = _op_case(
        band, lambda v, ref: ssim_loss(v, ref, band=spatial.current()),
        torch.rand(2, 16, 12, 3, generator=torch.Generator().manual_seed(4)), dim=1,
        extra=("band", y))
    image = torch.rand(2, 16, 12, 3, generator=torch.Generator().manual_seed(5))
    out["smoothness"] = _op_case(
        band, lambda v, img: smoothness_loss([v], [img], 1.0, spatial.current()),
        torch.rand(2, 16, 12, 1, generator=torch.Generator().manual_seed(6)) + 0.1, dim=1,
        extra=("whole", image))
    return out


def _no_exchange(t, group):
    """The control's exchange: every other band's rows come as zeros."""
    me = torch.distributed.get_rank(group)
    return [t if r == me else torch.zeros_like(t)
            for r in range(torch.distributed.get_world_size(group))]


def main():
    data_dir = sys.argv[1]
    torch.set_num_threads(1)
    mesh.init_distributed(device="cpu")
    rank, world = mesh.process_index(), mesh.process_count()
    configs = torch.load(os.path.join(data_dir, "configs.pt"))
    grid = mesh.make_mesh_2d(spatial_shards=2)
    out = dict(grid=dict(data_count=grid.data_count, space_count=grid.space_count,
                         data_index=grid.data_index, space_index=grid.space_index))
    if world == 2:
        out["ops"] = op_cases(grid.band())
        state0 = torch.load(os.path.join(data_dir, "packnet_state0.pt"))
        batch = load_batch(os.path.join(data_dir, "batch2.npz"))
        out["packnet"] = train_step(configs["packnet"], state0, batch, grid)
        exchange = spatial._gather
        spatial._gather = _no_exchange
        out["zero_pad"] = train_step(configs["packnet"], state0, batch, grid)
        spatial._gather = exchange
        out["eval"] = eval_rows(configs["packnet"], state0,
                                load_batch(os.path.join(data_dir, "eval2.npz")), grid)
    else:
        state0 = torch.load(os.path.join(data_dir, "resnet_state0.pt"))
        batch = load_batch(os.path.join(data_dir, "batch8.npz"))
        lo = 4 * grid.data_index
        out["resnet"] = train_step(configs["resnet"], state0, rows(batch, lo, lo + 4), grid)
        grid4 = mesh.make_mesh_2d(spatial_shards=4)
        try:
            train_step(configs["packnet"], torch.load(os.path.join(data_dir,
                                                                  "packnet_state0.pt")),
                       load_batch(os.path.join(data_dir, "batch2.npz")), grid4)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    mesh.barrier()
    torch.save(out, os.path.join(data_dir, f"rank{rank}_world{world}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    main()
