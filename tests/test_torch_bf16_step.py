"""The train steps under the bfloat16 policy (``arch.dtype: bfloat16``), the
port against the JAX package's bfloat16 steps on the same weights and
batches, on the CPU.

- The flagship step (SelfSupModel, PackNetSlim01-1A + PoseNet standing in
  for PackNet01 at test size, the KITTI loss: 4 scales, automask, min
  reduction) at 64x96, batch 2, 3 plain SGD steps at lr 1e-2 as
  tests/test_torch_flagship_step.py runs them in float32. The intrinsics
  are bfloat16-representable (fx = fy = 60, cx = 47.5, cy = 31.5), so that
  JAX's rounding of them (ROADMAP.md §3 (h)) changes nothing here.
- The NRS step (GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet, the
  omnicam loss) at 96x96, progress 0.3, 3 Adam steps, as
  tests/test_torch_train_step.py runs it in float32.

What is held: per-step losses, the gradient's cosine on the first batch,
and for the flagship the update after step 1 (under SGD, -lr times the
gradient) and over the 3 steps, by their cosines. Both packages round every
PackNet and PoseNet layer's output to bfloat16 and take the same bfloat16
images; XLA keeps fused elementwise chains in float32, eager PyTorch rounds
each op, so the port's loss math runs in float32 (``_photometric_map``).
They part by bfloat16 roundings near boundaries, which the min reduction,
the automask and (in NRS) the soft-argmax at T ~ 1e-4 amplify. The bounds
sit under the port's own floor in bfloat16: the port against itself from
weights perturbed by one bfloat16 spacing, a relative 2^-8, the bfloat16
analog of the float32 tests' 1e-7, as the weights are rounded to bfloat16
where they are used (``PYTHONPATH=. python tests/test_torch_bf16_step.py``
prints both, and the floor at 1e-7). Measured on a CPU:
- flagship: port against JAX, losses 3.0e-4, 3.0e-3, 1.3e-3 relative,
  gradient cosine 0.99536, update cosines 0.99536 (step 1) and 0.99328 (3
  steps); the floor over 3 draws, losses up to 2.4e-4, 9.6e-5, 5.3e-4,
  gradient cosine 0.979-0.987, 3 steps 0.977-0.985 (at 1e-7: 0.9993-
  0.9999). Bounds: loss rtol 1e-2 each step, cosines >= 0.97;
- NRS: port against JAX, losses 5.2e-3, 1.5e-2, 1.8e-2, gradient cosine
  0.364; the floor, losses up to 9.4e-4, 6.7e-3, 1.2e-2, gradient cosine
  0.10-0.18 (at 1e-7: 0.81-0.90). In bfloat16 the NRS gradient is
  noise: PoseNet's bfloat16 pose (5e-3 apart between the two packages, as
  each is from float32) moves correspondences that T ~ 1e-4 turns into
  gradients, and Adam's first update, about sign(g), keeps even less
  (update cosines 0.11-0.20 at the floor): so the update is not held.
  Bounds: loss rtol 2e-2, 5e-2, 1e-1, gradient cosine >= 0.05.
The bfloat16 loss of the first batch lies from the float32 one by 4.0e-3
(JAX) and 1.2e-3 (the port) in NRS, 1.1e-4 and 4.0e-4 in the flagship: the
port's bfloat16 loss is held within 2e-2 of its own float32 one.
The loss comes back in float32 and the parameters stay float32.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import merge_config as jax_merge_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.train import TrainState, _cast_tree
from packnet_sfm_tpu.engine.train import make_train_step as jax_make_train_step
from packnet_sfm_tpu.engine.train import prepare_train_batch as jax_prepare_train_batch
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu.models.sfm import model_loss as jax_model_loss
from packnet_sfm_tpu.parallel.mesh import make_mesh, shard_batch
from packnet_sfm_tpu_torch.core.config import KITTI, OMNICAM, config_from_dict
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.train import (
    cast_batch,
    make_train_step,
    prepare_train_batch,
    zero_metrics,
)
from packnet_sfm_tpu_torch.models.sfm import model_loss
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

N_STEPS = 3
LR = 1e-2
PROGRESS = 0.3
STEPS_PER_EPOCH = 1000


def _smooth(rng, b, h, w):
    """Low-res noise, bilinear-upsampled x8 (NHWC), as tests/test_lockstep.py."""
    base = torch.from_numpy(rng.uniform(size=(b, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def _intrinsics(b, h, w):
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 60.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2 - 0.5, h / 2 - 0.5, 1.0
    return K


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _committed(tree, mesh):
    """``tree`` committed to ``mesh``, as JAX's step returns its state and
    metrics: from uncommitted ones its first call would compile a second
    program (the same numbers)."""
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _flat(state: dict, keys) -> np.ndarray:
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


# Each kind: (batches, JAX config, port config, JAX optimizer, port optimizer
# factory, progress).
def _kind(kind):
    if kind == "flagship":
        rng = np.random.default_rng(42)
        b, h, w = 2, 64, 96
        batches = [{"rgb": _smooth(rng, b, h, w),
                    "rgb_context": [_smooth(rng, b, h, w), _smooth(rng, b, h, w)],
                    "intrinsics": _intrinsics(b, h, w)} for _ in range(N_STEPS)]
        jcfg = jax_default_config()
        jcfg.model.name = "SelfSupModel"
        jcfg.model.depth_net.name = "PackNetSlim01"
        jcfg.model.depth_net.version = "1A"
        jcfg.model.pose_net.name = "PoseNet"
        jcfg.model.loss.flip_lr_prob = 0.0
        cfg = config_from_dict(KITTI)
        cfg.model.depth_net.name = "PackNetSlim01"
        cfg.model.loss.flip_lr_prob = 0.0
        return (batches, jcfg, cfg, lambda _: optax.sgd(LR),
                lambda model, _: (torch.optim.SGD(model.parameters(), lr=LR), None), 0.0)
    rng = np.random.default_rng(5)
    batches = [{"rgb": _smooth(rng, 1, 96, 96),
                "rgb_context": [_smooth(rng, 1, 96, 96), _smooth(rng, 1, 96, 96)]}
               for _ in range(N_STEPS)]
    jcfg = jax_merge_config(jax_default_config(), OMNICAM)
    jcfg.model.depth_net.version = "18"
    cfg = config_from_dict(OMNICAM)

    def port_optimizer(model, cfg):
        return make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, STEPS_PER_EPOCH)

    def jax_optimizer(jcfg):
        return jax_factory.make_optimizer(jcfg.model.optimizer, jcfg.model.scheduler,
                                          STEPS_PER_EPOCH)
    return batches, jcfg, cfg, jax_optimizer, port_optimizer, PROGRESS


def _port_steps(kind, state0, perturb_seed=None, perturb=1e-7):
    """N_STEPS port steps in bfloat16 from ``state0``, its weights perturbed
    by a relative ``perturb`` where ``perturb_seed`` is given: (losses,
    states, the starting state)."""
    batches, _, cfg, _, port_optimizer, progress = _kind(kind)
    model = setup_model(cfg.model, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(state0, strict=True)
    if perturb_seed is not None:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for prm in model.parameters():
                prm.mul_(1 + perturb * torch.randn(prm.shape, generator=gen))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = port_optimizer(model, cfg)
    step = make_train_step(model, optimizer, scheduler, num_scales=4 if kind == "flagship"
                           else None, compute_dtype=torch.bfloat16)
    acc = zero_metrics("cpu")
    losses, states, prev = [], [], 0.0
    for b in batches:
        acc = step(acc, b, progress=progress)
        cum = float(acc["loss"][0])
        losses.append(cum - prev)
        prev = cum
        states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert acc["loss"].dtype == torch.float32
    return np.array(losses), states, start


def _port_gradient(kind, state0, perturb_seed=None, perturb=1e-7):
    """The port's bfloat16 loss gradient on the first batch, flattened over
    ``keys``, from ``state0`` (perturbed as in ``_port_steps``)."""
    batches, _, cfg, _, _, progress = _kind(kind)
    model = setup_model(cfg.model, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(state0, strict=True)
    if perturb_seed is not None:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for prm in model.parameters():
                prm.mul_(1 + perturb * torch.randn(prm.shape, generator=gen))
    batch = cast_batch(prepare_train_batch(batches[0], "cpu"), torch.bfloat16)
    loss, _ = model_loss(model, batch, progress=progress,
                         num_scales=4 if kind == "flagship" else None)
    loss.float().backward()
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
            for k, p in model.named_parameters()}


def _run_both(kind):
    batches, jcfg, _, jax_optimizer, _, progress = _kind(kind)
    jmodel = jax_factory.setup_model(jcfg.model, dtype=jnp.bfloat16)
    variables = init_model(jmodel, jax.random.PRNGKey(0), batches[0])
    state0 = from_jax(_np_tree(variables["params"]), _np_tree(variables.get("batch_stats", {})))
    # the port's steps run in a thread while XLA compiles JAX's (both
    # release the interpreter while they compute)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(lambda: (_port_steps(kind, state0), _port_gradient(kind, state0)))
        jax_side = _jax_steps(kind, jmodel, variables, batches, jcfg, jax_optimizer, progress)
        (t_losses, t_params, _), t_grads = port.result()
    return dict(state0=state0, t_grads=t_grads, t_losses=t_losses, t_params=t_params,
                **jax_side)


def _jax_steps(kind, jmodel, variables, batches, jcfg, jax_optimizer, progress):
    """JAX's gradient on the first batch and its N_STEPS bfloat16 steps."""

    def loss_fn(params, batch):
        v = dict(variables, params=params)
        batch = _cast_tree(jax_prepare_train_batch(batch), jnp.bfloat16)
        loss = jax_model_loss(jmodel, v, batch, jax.random.PRNGKey(0), progress=progress,
                              num_scales=4 if kind == "flagship" else None)[0]
        return loss.astype(jnp.float32)

    j_grads = from_jax(_np_tree(jax.jit(jax.grad(loss_fn))(
        variables["params"], jax.tree_util.tree_map(jnp.asarray, batches[0]))))
    tx = jax_optimizer(jcfg)
    mesh = make_mesh(num_devices=1)
    state = _committed(TrainState.create(variables, tx), mesh)
    step = jax_make_train_step(jmodel, tx, mesh, num_scales=4 if kind == "flagship" else None,
                               compute_dtype=jnp.bfloat16)
    acc = _committed(jax_zero_metrics(), mesh)
    j_losses, j_params, prev = [], [], 0.0
    for b in batches:
        state, acc = step(state, acc, shard_batch(b, mesh), progress=progress)
        cum = float(acc["loss"][0])
        j_losses.append(cum - prev)
        prev = cum
        j_params.append(from_jax(_np_tree(state.params)))
    return dict(j_losses=np.array(j_losses), j_params=j_params, j_grads=j_grads)


def _keys(r):
    return sorted(r["j_grads"])


def _figures(r, losses, params, start, grads):
    """A port run against ``r``'s: per-step loss differences, the gradient
    cosine and the step-1 and N-step update cosines."""
    keys = _keys(r)
    p0, q0 = _flat(r["state0"], keys), _flat(start, keys)
    rel = np.abs(losses - r["t_losses"]) / np.abs(r["t_losses"])
    return rel, [_cos(_flat(r["t_grads"], keys), _flat(grads, keys))] + [
        _cos(_flat(a, keys) - p0, _flat(b, keys) - q0)
        for a, b in ((r["t_params"][0], params[0]), (r["t_params"][-1], params[-1]))]


# per kind: loss rtol of each step, the least gradient cosine, the least
# update cosines after step 1 and after the 3 steps (None: not held)
BOUNDS = {"flagship": ([1e-2, 1e-2, 1e-2], 0.97, 0.97, 0.97),
          "nrs": ([2e-2, 5e-2, 1e-1], 0.05, None, None)}


@pytest.fixture(scope="module", params=["flagship", "nrs"])
def runs(request):
    return request.param, _run_both(request.param)


def test_bf16_steps_match_jax(runs):
    kind, r = runs
    loss_rtol, cos_g, cos1, cos_n = BOUNDS[kind]
    assert np.all(np.isfinite(r["t_losses"]))
    rel = np.abs(r["t_losses"] - r["j_losses"]) / np.abs(r["j_losses"])
    assert np.all(rel <= loss_rtol), rel
    keys = _keys(r)
    assert _cos(_flat(r["t_grads"], keys), _flat(r["j_grads"], keys)) >= cos_g
    p0 = _flat(r["state0"], keys)
    t1, tn = _flat(r["t_params"][0], keys), _flat(r["t_params"][-1], keys)
    j1, jn = _flat(r["j_params"][0], keys), _flat(r["j_params"][-1], keys)
    assert np.linalg.norm(t1 - p0) > 0
    if cos1 is not None:
        assert _cos(t1 - p0, j1 - p0) >= cos1
        assert _cos(tn - p0, jn - p0) >= cos_n


def test_bf16_steps_differ_from_float32(runs):
    """The policy is on: the bfloat16 step's loss is not the float32 one's."""
    kind, r = runs
    batches, _, cfg, _, port_optimizer, progress = _kind(kind)
    model = setup_model(cfg.model, device="cpu")
    model.load_state_dict(r["state0"], strict=True)
    optimizer, scheduler = port_optimizer(model, cfg)
    step = make_train_step(model, optimizer, scheduler,
                           num_scales=4 if kind == "flagship" else None)
    loss32 = float(step(zero_metrics("cpu"), batches[0], progress=progress)["loss"][0])
    assert loss32 != r["t_losses"][0]
    assert abs(loss32 - r["t_losses"][0]) <= 2e-2 * abs(loss32)


if __name__ == "__main__":
    # Prints the figures the bounds rest on:
    #   PYTHONPATH=. python tests/test_torch_bf16_step.py
    jax.config.update("jax_platforms", "cpu")
    for kind in ("flagship", "nrs"):
        r = _run_both(kind)
        keys = _keys(r)
        p0 = _flat(r["state0"], keys)
        print(kind, "JAX vs port: step loss rel",
              np.abs(r["t_losses"] - r["j_losses"]) / np.abs(r["j_losses"]))
        print(kind, "JAX vs port: gradient and update cosines",
              [_cos(_flat(r["t_grads"], keys), _flat(r["j_grads"], keys))]
              + [_cos(_flat(a, keys) - p0, _flat(b, keys) - p0)
                 for a, b in ((r["t_params"][0], r["j_params"][0]),
                              (r["t_params"][-1], r["j_params"][-1]))])
        for perturb in (1e-7, 2.0 ** -8):
            for seed in range(3):
                losses, params, start = _port_steps(kind, r["state0"], seed, perturb)
                grads = _port_gradient(kind, r["state0"], seed, perturb)
                rel, cosines = _figures(r, losses, params, start, grads)
                print(kind, f"port vs port perturbed by {perturb:.2e} (seed {seed}): step "
                      "loss rel", rel, "gradient and update cosines", cosines)
