"""The port's NRS (GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet, the
loss of configs/train_omnicam.yaml) against the benchmark's plain reference
(``portbench/reference/nrs.py``, which imports nothing of the port), on the
same weights (the benchmark's draw from a seed) and the same batch (its
train traffic), float32 with TF32 off, at 96x96 (the smallest multiple of 32
whose half, 48, holds the 41x41 window of patch 20), batch 2, progress 0.5
(blend coefficient 1, T = 9.51e-5):

- the forward (the 4 inverse depths and the ray surface) against the
  reference in float32: the same operations, rtol 1e-5 (measured: equal);
- the projection of the first step's points through both projectors
  ('auto', 'plain') against the reference's soft-argmax in float64: within
  0.25 px at full resolution (measured 0.027 px: the float32 logits at
  T ~ 1e-4 carry ~6e-4 of rounding each, and a near tie turns that into a
  weight change between positions pixels apart); the temperature doubled
  reads 13.9 px;
- the loss against the float64 reference, rtol 1e-5 (measured 5.3e-7);
- each leaf's first gradient against the float64 reference: the worst
  leaf's norm gap (``portbench/yardstick.norm_gap``, over the leaves whose
  gradient is not nought to rounding) at most 0.2 (measured 0.071) and the
  whole gradient's cosine at least 0.99 (0.9969);
- one Adam step (``make_train_step``) against the reference's written-out
  Adam in float64: the update's cosine at least 0.9 (0.956; Adam's first
  update is about lr sign(g), and the leaves whose gradient the chaos moves
  flip some signs).

The objective at T ~ 1e-4 is chaotic (tests/test_torch_train_step.py): the
port against the float64 reference from weights moved by a relative 1e-7
reads, over four draws, loss 9.2e-7 to 3.0e-6, leaf gap 0.026 to 0.105,
gradient cosine 0.9956 to 0.9981, update cosine 0.947 to 0.961; the
float32 reference 5.3e-7, 0.032, 0.9974, 0.959. The bounds sit above that
floor. The control: the reference with every convolution rounded to
bfloat16 (its input, weight and output; ``nets.set_precision``), the
precision below the float32 that this comparison holds, reads 7.5e-4,
1.23, -0.034 and 0.035 (fp8: 2.1e-3, 2.61, 0.030, 0.030) and fails every
bound; the projection's control is the temperature doubled. The figures:

    PYTHONPATH=. python tests/test_torch_nrs_reference.py
"""

import pytest
import torch

from packnet_sfm_tpu_torch.core.config import OMNICAM, config_from_dict
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.train import make_train_step, prepare_train_batch, zero_metrics
from packnet_sfm_tpu_torch.geometry.camera_generic import (
    GenericCamera,
    canonical_pinhole_rays,
    generic_project,
    projection_temperature,
)
from packnet_sfm_tpu_torch.geometry.pose import pose_vec_to_mat
from packnet_sfm_tpu_torch.losses.generic_photometric import blend_ray_surface
from packnet_sfm_tpu_torch.models.sfm import model_loss
from portbench import weights, yardstick
from portbench.control import rounding
from portbench.reference import nets as ref_nets
from portbench.reference import nrs
from portbench.reference import steps as ref_steps
from portbench.traffic import train as train_traffic

torch.set_num_threads(1)

H = W = 96
PROGRESS = 0.5
SEED = 2 ** 31 + 21
TRAFFIC = {"batch": 2, "shape": [H, W], "contexts": 2, "jitter": [0.2, 0.2, 0.2, 0.05], "pool": 1}
FORWARD_RTOL, PROJECTION_PX, LOSS_RTOL = 1e-5, 0.25, 1e-5
GRAD_LEAF_GAP, GRAD_COSINE, UPDATE_COSINE = 0.2, 0.99, 0.9


def _cfg():
    return config_from_dict(OMNICAM)


def _host_batch():
    return train_traffic.make_pool(TRAFFIC, SEED, "cpu")[0]


def _program(perturb=None):
    model = setup_model(_cfg().model, device="cpu")
    weights.load(model, SEED)
    if perturb is not None:
        gen = torch.Generator().manual_seed(perturb)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    return model


def _reference(dtype, cast=None):
    nets = nrs.build()
    weights.load(nets, SEED)
    nets.to(dtype).train()
    ref_nets.set_precision(nets, cast)
    return nets


def _grads(named):
    return {n: p.grad.detach().double().clone() for n, p in named if p.grad is not None}


def _cos(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()))


def _flat(tensors, keys):
    return torch.cat([tensors[k].flatten() for k in keys])


def _program_step(host, perturb=None):
    """(loss, first gradients, one Adam step's update) of the port."""
    model = _program(perturb)
    loss, _ = model_loss(model, prepare_train_batch(host, "cpu"), progress=PROGRESS)
    loss.backward()
    grads = _grads(model.named_parameters())
    model = _program(perturb)
    cfg = _cfg()
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 10 ** 9)
    step = make_train_step(model, optimizer, scheduler)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(zero_metrics("cpu"), host, PROGRESS)
    update = {n: (p.detach() - start[n]).double() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, update


def _reference_step(host, dtype=torch.float64, cast=None):
    """(loss, first gradients, one Adam step's update) of the reference."""
    nets = _reference(dtype, cast)
    named = list(nets.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    loss = nrs.train_loss(nets, ref_steps.prepare(host, "cpu", None, dtype), PROGRESS)
    loss.backward()
    grads = _grads(named)
    ref_steps.Adam([p for _, p in named], [2e-4] * len(named)).step([p.grad for _, p in named])
    update = {n: (p.detach() - start[n]).double() for n, p in named}
    return float(loss.detach()), grads, update


def _gaps(got, want):
    """The numbers the bounds hold: loss rel, the worst leaf's first-gradient
    norm gap, the whole gradient's cosine, the update's cosine."""
    (loss, grads, update), (ref_loss, ref_grads, ref_update) = got, want
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    moved = yardstick.moved_leaves(norms)
    keys = sorted(moved)
    return {"loss": abs(loss - ref_loss) / abs(ref_loss),
            "grad_leaf_gap": yardstick.norm_gap({n: float(g.norm()) for n, g in grads.items()},
                                                norms, moved),
            "grad_cosine": _cos(_flat(grads, keys), _flat(ref_grads, keys)),
            "update_cosine": _cos(_flat(update, keys), _flat(ref_update, keys))}


def _within(g):
    return {"loss": g["loss"] <= LOSS_RTOL, "grad_leaf_gap": g["grad_leaf_gap"] <= GRAD_LEAF_GAP,
            "grad_cosine": g["grad_cosine"] >= GRAD_COSINE,
            "update_cosine": g["update_cosine"] >= UPDATE_COSINE}


def _projection_px(host, projector, temperature_scale=1.0):
    """The worst gap, in full-resolution pixels, between the port's
    projection of the first step's points into the first context and the
    reference's in float64."""
    model = _program()
    batch = prepare_train_batch(host, "cpu")
    with torch.no_grad():
        out = model.depth_net(batch["rgb"])
        pose = pose_vec_to_mat(model.pose_net(batch["rgb"], batch["rgb_context"])[:, 0])
        rays = blend_ray_surface(canonical_pinhole_rays(H, W, device="cpu"), out["ray_surface"], PROGRESS)
        points = rays / out["inv_depths"][0].clamp(min=1e-6)
        got = generic_project(GenericCamera(rays, pose), points,
                              temperature_scale * projection_temperature(PROGRESS),
                              projector=projector)
        want = nrs.project(rays.double(), points.double(), pose.double(),
                           nrs.temperature(PROGRESS))
    return float(((got.double() - want).abs() * (W - 1) / 2).max())


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture(scope="module")
def host():
    return _host_batch()


@pytest.fixture(scope="module")
def reference64(host):
    return _reference_step(host)


@pytest.fixture(scope="module")
def control(host, reference64):
    return _gaps(_reference_step(host, torch.float32, rounding("bfloat16")), reference64)


def test_the_networks_are_named_alike():
    program = {n: tuple(p.shape) for n, p in _program().named_parameters()}
    reference = {n: tuple(p.shape) for n, p in nrs.build().named_parameters()}
    assert program == reference


def test_forward(host):
    batch = prepare_train_batch(host, "cpu")
    model, nets = _program(), _reference(torch.float32)
    model.train()
    with torch.no_grad():
        got = model.depth_net(batch["rgb"])
        want = nets["depth_net"](batch["rgb"])
        low = _reference(torch.float32, rounding("bfloat16"))["depth_net"](batch["rgb"])
    pairs = list(zip(got["inv_depths"], want["inv_depths"], low["inv_depths"]))
    pairs.append((got["ray_surface"], want["ray_surface"], low["ray_surface"]))
    assert len(pairs) == 5 and tuple(pairs[-1][0].shape) == (2, H, W, 3)
    for g, w, lo in pairs:
        torch.testing.assert_close(g, w, rtol=FORWARD_RTOL, atol=FORWARD_RTOL)
    # the control: the reference's convolutions in bfloat16 leave the bound
    assert any((lo - w).abs().max() > FORWARD_RTOL * (1 + w.abs().max()) for _, w, lo in pairs)


@pytest.mark.parametrize("projector", ["auto", "plain"])
def test_projection(host, projector):
    assert _projection_px(host, projector) <= PROJECTION_PX


def test_projection_control_fails(host):
    assert _projection_px(host, "auto", temperature_scale=2.0) > PROJECTION_PX


def test_loss_first_gradient_and_one_adam_update(host, reference64, control):
    gaps = _gaps(_program_step(host), reference64)
    assert all(_within(gaps).values()), gaps
    # the bfloat16 control fails each bound
    assert not any(_within(control).values()), control


if __name__ == "__main__":
    # the figures the bounds rest on: the port, the port from weights moved
    # by a relative 1e-7 (four draws), the float32 reference and the
    # control, each against the float64 reference; and the projections
    b = _host_batch()
    ref = _reference_step(b)
    print("port", _gaps(_program_step(b), ref))
    for seed in range(4):
        print("port perturbed", seed, _gaps(_program_step(b, perturb=seed), ref))
    print("reference float32", _gaps(_reference_step(b, torch.float32), ref))
    print("control bfloat16", _gaps(_reference_step(b, torch.float32, rounding("bfloat16")), ref))
    print("control fp8", _gaps(_reference_step(b, torch.float32, rounding("fp8")), ref))
    for proj in ("auto", "plain"):
        print("projection px", proj, _projection_px(b, proj))
    print("projection px, T doubled", _projection_px(b, "auto", 2.0))
