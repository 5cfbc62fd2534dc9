"""One rank of tests/test_torch_spatial_kinds.py, launched by it with
``torch.distributed.run --standalone``; imports only the port, torch and
numpy.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_spatial_kinds_worker.py <data dir>

The test writes the starting weights, the batches and the configs into
<data dir>; each rank joins the gloo group on the CPU, runs the cases of its
world size and writes what it got to <data dir>/rank<r>_world<n>.pt.

Two ranks (space 2):
- 'ops': on this rank's band against the same rows of the whole op (each
  rank computes both), as the largest error relative to the whole op's
  largest value: the band form of the plain soft-argmax at a 64x48 grid,
  p = 20, T = 0.05 and 1e-4 (ex, ey, d direction, and the ray band's
  gradient, the slab's d rays summed over the bands through the halo's
  backward); the band resizes (bilinear align_corners down, up and by a
  factor that is not an integer; nearest), forward and input gradient; the
  ten supervised methods on a band (the shares summed over the group
  against the whole loss, and the predictions' gradients);
- 'nrs': one Adam step of configs/train_omnicam.yaml's model at 128x96 on
  the batch of 2; 'nrs_zero_halo': the same with the rows of the ray slab
  from the other band replaced by zeros (the control).

Four ranks:
- 'ops': the soft-argmax and resize cases on space 4, where a band of the
  64-row grid (16 rows) is shallower than the 20-row reach of a window;
- 'velsup', 'semisup_berhu', 'semisup_silog': one Adam step of
  DepthResNet-18 + PoseNet on data 2 x space 2, this data rank's 4 rows of
  the global batch of 8;
- 'refused': the error of a SemiSupCompletionModel train step on that grid
  (None where none was raised).
"""

import os
import sys

import numpy as np
import torch

from packnet_sfm_tpu_torch.core.config import config_from_dict
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
from packnet_sfm_tpu_torch.geometry import camera_generic
from packnet_sfm_tpu_torch.losses import supervised
from packnet_sfm_tpu_torch.ops.image import interpolate_image
from packnet_sfm_tpu_torch.ops.softargmax import ray_slab, softargmax_coords_plain
from packnet_sfm_tpu_torch.parallel import mesh, spatial
from tests.torch_distributed_worker import rows
from tests.torch_spatial_worker import _no_exchange, _rel

STEPS_PER_EPOCH = 1000
PATCH = 20
GRID = (2, 3, 64, 48)        # the half-resolution grid of a 128x96 image, B = 2
SUPERVISED_METHODS = [f"{p}{m}" for p in ("", "sparse-")
                      for m in ("l1", "mse", "berhu", "silog", "abs_rel")]


def load_batch(path):
    """A batch saved by the test: its arrays, 'ctx<i>' as 'rgb_context' and
    'pose<i>' as 'pose_context'."""
    data = np.load(path)
    out = {k: data[k] for k in data.files if not k.startswith(("ctx", "pose"))}
    for prefix, key in (("ctx", "rgb_context"), ("pose", "pose_context")):
        names = sorted(k for k in data.files if k.startswith(prefix))
        if names:
            out[key] = [data[k] for k in names]
    return out


def train_step(cfg_dict, state0, batch, grid=None, progress=0.0):
    """One Adam step from ``state0``: loss, metrics and state dict."""
    cfg = config_from_dict(cfg_dict)
    model = setup_model(cfg.model, device="cpu")
    if state0 is not None:
        model.load_state_dict(state0, strict=True)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                          STEPS_PER_EPOCH)
    step = make_train_step(model, optimizer, scheduler, mesh=grid)
    acc = step(zero_metrics("cpu"), batch, progress)
    return dict(loss=float(acc["loss"][0]),
                metrics={k: float(v[0]) for k, v in acc.items() if float(v[1]) > 0},
                state={k: v.clone() for k, v in model.state_dict().items()})


# --- the ops --------------------------------------------------------------------------

def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(v / np.linalg.norm(v, axis=1, keepdims=True))


def softargmax_case(band, temperature):
    """The band form of the plain soft-argmax (the ray slab taken with
    ``spatial.take_rows`` as ``generic_project`` takes it) against the rows
    of the whole: ex, ey, d direction and the ray band's gradient."""
    rng = np.random.default_rng(3)
    direction, rays = _unit(rng, GRID), _unit(rng, GRID)
    a, c = (torch.from_numpy(rng.standard_normal((GRID[0],) + GRID[2:]).astype(np.float32))
            for _ in range(2))
    d, r = direction.clone().requires_grad_(), rays.clone().requires_grad_()
    ex, ey = softargmax_coords_plain(d, r, temperature, PATCH)
    ((ex * a).sum() + (ey * c).sum()).backward()
    h, height = GRID[2] // band.count, GRID[2]

    def slab(i):
        return ray_slab(i * h, h, height, PATCH)

    db = band.take(direction, 2).clone().requires_grad_()
    rb = band.take(rays, 2).clone().requires_grad_()
    exb, eyb = softargmax_coords_plain(
        db, spatial.take_rows(rb, slab, dim=2, band=band), temperature, PATCH,
        row0=band.start(h), height=height, ray_row0=slab(band.index)[0])
    ((exb * band.take(a, 1)).sum() + (eyb * band.take(c, 1)).sum()).backward()
    return dict(forward=max(_rel(exb.detach(), band.take(ex.detach(), 1)),
                            _rel(eyb.detach(), band.take(ey.detach(), 1))),
                d_direction=_rel(db.grad, band.take(d.grad, 2)),
                d_rays=_rel(rb.grad, band.take(r.grad, 2)))


def resize_case(band, shape, out_shape, mode):
    """A band resize against the rows of the whole one, and its input
    gradient (the gradient's rows of other bands sent back to them)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(shape, generator=gen)
    g = torch.rand((shape[0],) + tuple(out_shape) + (shape[3],), generator=gen)
    xw = x.clone().requires_grad_()
    yw = interpolate_image(xw, out_shape, mode=mode)
    (yw * g).sum().backward()
    xb = band.take(x).clone().requires_grad_()
    yb = interpolate_image(xb, out_shape, mode=mode, band=band)
    (yb * band.take(g)).sum().backward()
    return dict(forward=_rel(yb.detach(), band.take(yw.detach())),
                input_grad=_rel(xb.grad, band.take(xw.grad)))


def supervised_case(band, method):
    """A supervised method's shares, summed over the space group, against
    the whole loss (relative), and the predictions' gradients."""
    rng = np.random.default_rng(SUPERVISED_METHODS.index(method))
    preds = [torch.from_numpy(rng.uniform(0.02, 1.5, size=(2, 32 >> i, 48 >> i, 1))
                              .astype(np.float32)) for i in range(4)]
    gt = rng.uniform(0.01, 1.0, size=(2, 75, 124, 1)).astype(np.float32)
    gt = torch.from_numpy(gt * (rng.uniform(size=gt.shape) < 0.3).astype(np.float32))
    cfg = supervised.SupervisedLossConfig(supervised_method=method)
    whole = [p.clone().requires_grad_() for p in preds]
    want, _ = supervised.supervised_loss(whole, gt, cfg)
    want.backward()
    mine = [band.take(p).clone().requires_grad_() for p in preds]
    got, _ = supervised.supervised_loss(mine, gt, cfg, band, band.group)
    got.backward()
    total = got.detach().clone()
    torch.distributed.all_reduce(total, group=band.group)
    return dict(loss=float(abs(total - want.detach()) / abs(want.detach())),
                grads=max(_rel(m.grad, band.take(w.grad)) for m, w in zip(mine, whole)))


def op_cases(band, with_supervised):
    out = {f"softargmax_T{t:g}": softargmax_case(band, t) for t in (0.05, 1e-4)}
    for name, shape, out_shape, mode in (
            ("bilinear_down", (2, 128, 96, 3), (64, 48), "bilinear"),
            ("bilinear_up", (2, 64, 48, 2), (128, 96), "bilinear"),
            ("bilinear_odd", (2, 128, 96, 3), (40, 30), "bilinear"),
            ("nearest_down", (2, 128, 96, 1), (96, 40), "nearest"),
            ("nearest_up", (2, 64, 48, 1), (128, 96), "nearest")):
        out[f"resize_{name}"] = resize_case(band, shape, out_shape, mode)
    if with_supervised:
        for method in SUPERVISED_METHODS:
            out[f"supervised_{method}"] = supervised_case(band, method)
    return out


class _ZeroRaySlab:
    """``geometry/camera_generic``'s view of ``parallel/spatial`` for the
    control: the ray slab's rows from the other bands come as zeros."""

    def __getattr__(self, name):
        return getattr(spatial, name)

    @staticmethod
    def take_rows(x, bounds, dim=2, band=None):
        exchange = spatial._gather
        spatial._gather = _no_exchange
        try:
            return spatial.take_rows(x, bounds, dim, band)
        finally:
            spatial._gather = exchange


def main():
    data_dir = sys.argv[1]
    torch.set_num_threads(1)
    mesh.init_distributed(device="cpu")
    rank, world = mesh.process_index(), mesh.process_count()
    configs = torch.load(os.path.join(data_dir, "configs.pt"))
    out = {}
    if world == 2:
        grid = mesh.make_mesh_2d(spatial_shards=2)
        out["ops"] = op_cases(grid.band(), with_supervised=True)
        state0 = torch.load(os.path.join(data_dir, "nrs_state0.pt"))
        batch = load_batch(os.path.join(data_dir, "nrs2.npz"))
        progress = configs["nrs_progress"]
        out["nrs"] = train_step(configs["nrs"], state0, batch, grid, progress)
        camera_generic.spatial = _ZeroRaySlab()
        try:
            out["nrs_zero_halo"] = train_step(configs["nrs"], state0, batch, grid, progress)
        finally:
            camera_generic.spatial = spatial
    else:
        grid4 = mesh.make_mesh_2d(spatial_shards=4)
        out["ops"] = op_cases(grid4.band(), with_supervised=False)
        grid = mesh.make_mesh_2d(spatial_shards=2)
        out["grid"] = (grid.data_index, grid.space_index)
        state0 = torch.load(os.path.join(data_dir, "resnet_state0.pt"))
        batch = load_batch(os.path.join(data_dir, "batch8.npz"))
        lo = 4 * grid.data_index
        mine = rows(batch, lo, lo + 4)
        for kind in ("velsup", "semisup_berhu", "semisup_silog"):
            out[kind] = train_step(configs[kind], state0, mine, grid)
        try:
            train_step(configs["san"], None, mine, grid)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    mesh.barrier()
    torch.save(out, os.path.join(data_dir, f"rank{rank}_world{world}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    main()
