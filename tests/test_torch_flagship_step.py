"""The whole slice: the pinhole self-supervised train step (SelfSupModel,
PackNetSlim01-1A + PoseNet standing in for PackNet01 at test size, the
flagship loss configuration: 4 scales, automask, min reduction) in the port
against the JAX package, on the same weights and the same batches, float32
on the CPU; and the pieces around it (multiview loss, device jitter,
progressive schedule, training flip, gradient accumulation).

Tolerances, and what was measured on a CPU:
- multiview photometric loss and its metrics on given depths and poses, both
  paths (contexts stacked, and per context with clip_loss): rtol 1e-5;
- jitter: atol 2e-6 on images in [0, 1] (same float32 formulas);
- model_loss through the networks, flip off and flip forced on: rtol 1e-4
  (measured 5e-7 and 7e-7; the networks' rounding goes through 1/inv_depth);
- lockstep, plain SGD at lr 1e-2 as tests/test_lockstep.py, 3 steps at
  64x96, batch 2: per-step loss rtol 1e-4 (measured 9e-7 at most); the
  update cosine after step 1, which under SGD is the gradient cosine,
  >= 0.9999 (measured 0.99999995), and over the 3 steps >= 0.999 (measured
  0.9999998).
  The min reduction and the automask select per pixel, and near-ties flip
  under float32 rounding, hence cosines and not elementwise gradients;
- grad_accum=2 against one step on the whole batch (port only; every term
  of the loss is a mean over the batch of per-sample means): update cosine
  >= 0.99999 and loss rtol 1e-5 (measured 0.99999998 and 8e-8).
``PYTHONPATH=. python tests/test_torch_flagship_step.py`` prints the
lockstep's figures.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.datasets import augmentations as jaug
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.train import TrainState
from packnet_sfm_tpu.engine.train import make_train_step as jax_make_train_step
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.geometry.pose import pose_vec_to_mat as jax_pose_vec_to_mat
from packnet_sfm_tpu.losses import photometric as jphoto
from packnet_sfm_tpu.losses import progressive as jprogressive
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu.models.sfm import model_loss as jax_model_loss
from packnet_sfm_tpu.ops import jitter as jjitter
from packnet_sfm_tpu.parallel.mesh import make_mesh, shard_batch
from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict
from packnet_sfm_tpu_torch.datasets import augmentations as taug
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.train import (
    make_train_step,
    prepare_train_batch,
    zero_metrics,
)
from packnet_sfm_tpu_torch.losses import photometric as tphoto
from packnet_sfm_tpu_torch.losses import progressive as tprogressive
from packnet_sfm_tpu_torch.models.sfm import model_loss
from packnet_sfm_tpu_torch.ops import jitter as tjitter
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

BATCH, H, W = 2, 64, 96
N_STEPS = 3
LR = 1e-2


def _smooth(rng, b=BATCH, h=H, w=W):
    """Low-res noise, bilinear-upsampled x8 (NHWC), as tests/test_lockstep.py."""
    base = torch.from_numpy(rng.uniform(size=(b, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def _intrinsics(b=BATCH, h=H, w=W):
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 60.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2 - 0.5, h / 2 - 0.5, 1.0
    return K


def _batches(n=N_STEPS):
    rng = np.random.default_rng(42)
    return [{"rgb": _smooth(rng), "rgb_context": [_smooth(rng), _smooth(rng)],
             "intrinsics": _intrinsics()} for _ in range(n)]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _flat(state: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(state[k], np.float64).ravel() for k in keys])


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


# --- the loss on given depths and poses ---------------------------------------

LOSS_CASES = {
    "stacked-min-automask": dict(),
    "stacked-mean": dict(photometric_reduce_op="mean", automask_loss=False),
    "per-context-clip": dict(clip_loss=0.5),
    "per-context-clip-mean-border": dict(clip_loss=0.5, photometric_reduce_op="mean",
                                         automask_loss=False, padding_mode="border"),
    "two-scales-no-ssim": dict(num_scales=2, ssim_loss_weight=0.0, smooth_loss_weight=0.0),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_multiview_photometric_loss_matches_jax(case):
    rng = np.random.default_rng(0)
    h, w = 32, 48
    image = _smooth(rng, 2, h, w)
    context = [_smooth(rng, 2, h, w), _smooth(rng, 2, h, w)]
    inv_depths = [rng.uniform(0.05, 0.5, size=(2, h >> i, w >> i, 1)).astype(np.float32)
                  for i in range(4)]
    K = _intrinsics(2, h, w)
    K[:, 0, 0] = K[:, 1, 1] = 30.0
    vecs = (rng.normal(size=(2, 2, 6)) * [0.2, 0.05, 0.1, 0.01, 0.02, 0.01]).astype(np.float32)
    poses = [np.array(jax_pose_vec_to_mat(vecs[i])) for i in range(2)]

    want, want_metrics = jphoto.multiview_photometric_loss(
        image, context, inv_depths, K, poses,
        jphoto.MultiViewPhotometricConfig(**LOSS_CASES[case]))
    t = torch.from_numpy
    got, got_metrics = tphoto.multiview_photometric_loss(
        t(image), [t(c) for c in context], [t(d) for d in inv_depths], t(K),
        [t(p) for p in poses], tphoto.MultiViewPhotometricConfig(**LOSS_CASES[case]))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert got_metrics.keys() == want_metrics.keys()
    for key, value in want_metrics.items():
        np.testing.assert_allclose(got_metrics[key].item(), float(value), rtol=1e-5, err_msg=key)


def test_loss_config_refuses_automask_without_min():
    with pytest.raises(ValueError):
        tphoto.MultiViewPhotometricConfig(photometric_reduce_op="mean")


# --- jitter, schedule -----------------------------------------------------------

def test_apply_jitter_matches_jax():
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(3, 16, 20, 3)).astype(np.float32)
    image[0, 0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]   # grey and pure
    params = np.array([[1, 1, 1, 0], [1.15, 0.85, 1.2, 0.04], [0.8, 1.2, 0.9, -0.05]],
                      np.float32)
    got = tjitter.apply_jitter(torch.from_numpy(image), torch.from_numpy(params))
    np.testing.assert_allclose(got.numpy(), np.asarray(jjitter.apply_jitter(image, params)),
                               atol=2e-6)
    np.testing.assert_allclose(got[0].numpy(), image[0], atol=2e-6)        # identity row
    hsv = tjitter.rgb_to_hsv(torch.from_numpy(image))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jjitter.rgb_to_hsv(image)), atol=2e-6)
    np.testing.assert_allclose(tjitter.hsv_to_rgb(hsv).numpy(),
                               np.asarray(jjitter.hsv_to_rgb(np.asarray(hsv))), atol=2e-6)
    np.testing.assert_allclose(tjitter.hsv_to_rgb(hsv).numpy(), image, atol=1e-5)


def test_draw_jitter_params_copy_matches_the_jax_package():
    for seed in range(4):
        ours = taug.draw_jitter_params((0.2, 0.2, 0.2, 0.05), np.random.default_rng(seed),
                                       prob=0.7)
        theirs = jaug.draw_jitter_params((0.2, 0.2, 0.2, 0.05), np.random.default_rng(seed),
                                         prob=0.7)
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == np.float32 and ours.shape == (4,)


def test_prepare_train_batch_decodes_and_jitters():
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, size=(2, 8, 12, 3), dtype=np.uint8)
    params = np.array([[1.1, 0.9, 1.2, 0.03], [0.9, 1.1, 0.8, -0.02]], np.float32)
    batch = {"rgb": u8, "rgb_context": [u8[::-1].copy()], "jitter": params,
             "intrinsics": _intrinsics(2, 8, 12)}
    out = prepare_train_batch(batch, "cpu")
    np.testing.assert_allclose(out["rgb_original"].numpy(), u8.astype(np.float32) / 255.0,
                               rtol=1e-6)
    want = jjitter.apply_jitter(u8.astype(np.float32) * np.float32(1 / 255.0), params)
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(want), atol=2e-6)
    assert out["rgb_context"][0] is not out["rgb_context_original"][0]
    assert out["intrinsics"].dtype == torch.float32
    plain = prepare_train_batch({k: v for k, v in batch.items() if k != "jitter"}, "cpu")
    assert plain["rgb"] is plain["rgb_original"]
    assert plain["rgb_context"] is plain["rgb_context_original"]


@pytest.mark.parametrize("scaling", [0.0, 0.2, 0.25, 0.5])
def test_progressive_schedule_matches_jax(scaling):
    for progress in np.linspace(0.0, 1.0, 41):
        assert tprogressive.progressive_num_scales(float(progress), 4, scaling) == \
            jprogressive.progressive_num_scales(float(progress), 4, scaling)
    assert tprogressive.progressive_num_scales(0.0, 4, 0.0) == 4


# --- the step -------------------------------------------------------------------

def _port_config():
    cfg = config_from_dict(KITTI)
    cfg.model.depth_net.name = "PackNetSlim01"
    return cfg


def _port_model(state, flip_lr_prob=0.0):
    cfg = _port_config()
    cfg.model.loss.flip_lr_prob = flip_lr_prob
    model = setup_model(cfg.model, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def _sgd_steps(model, batches, **kw):
    """Port SGD steps: (per-step losses, parameters after each step)."""
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), **kw)
    acc = zero_metrics("cpu")
    losses, params, prev = [], [], 0.0
    for b in batches:
        acc = step(acc, b, progress=0.0)
        cum = float(acc["loss"][0])
        losses.append(cum - prev)
        prev = cum
        params.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    return np.array(losses), params, acc


def _run_both():
    batches = _batches()
    jcfg = jax_default_config()
    jcfg.model.name = "SelfSupModel"
    jcfg.model.depth_net.name = "PackNetSlim01"
    jcfg.model.depth_net.version = "1A"
    jcfg.model.pose_net.name = "PoseNet"
    jcfg.model.loss.flip_lr_prob = 0.0
    jmodel = jax_factory.setup_model(jcfg.model)
    variables = init_model(jmodel, jax.random.PRNGKey(0), batches[0])
    params0 = _np_tree(variables["params"])
    state0 = from_jax(params0)
    # the port's steps run in a thread while XLA compiles JAX's (both
    # release the interpreter while they compute)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(lambda: _sgd_steps(_port_model(state0), batches, num_scales=4))
        jax_side = _jax_steps(jmodel, variables, batches)
        t_losses, t_params, tacc = port.result()
    return dict(batches=batches, state0=state0, t_losses=t_losses, t_params=t_params,
                tacc=tacc, **jax_side)


def _jax_steps(jmodel, variables, batches):
    """JAX's loss with the flip forced on, and its 3 SGD steps."""
    # JAX: model_loss with the flip forced on (forward only)
    flipped = dataclasses.replace(jmodel, flip_lr_prob=1.0)
    j_flip = float(jax.jit(lambda v, b: jax_model_loss(
        flipped, v, b, rng=jax.random.PRNGKey(1))[0])(variables, batches[0]))

    # JAX: 3 SGD steps on a 1-device mesh
    tx = optax.sgd(LR)
    mesh = make_mesh(num_devices=1)
    state = TrainState.create(variables, tx)
    step = jax_make_train_step(jmodel, tx, mesh, num_scales=4)
    acc = jax_zero_metrics()
    j_losses, j_params, prev = [], [], 0.0
    for b in batches:
        state, acc = step(state, acc, shard_batch(b, mesh), progress=0.0)
        cum = float(acc["loss"][0])
        j_losses.append(cum - prev)
        prev = cum
        j_params.append(from_jax(_np_tree(state.params)))
    j_metrics = {k: float(acc[k][0]) for k in ("photometric_loss", "smoothness_loss")}
    return dict(j_flip=j_flip, j_losses=np.array(j_losses), j_params=j_params,
                j_metrics=j_metrics)


@pytest.fixture(scope="module")
def runs():
    return _run_both()


def test_lockstep_losses_match_jax(runs):
    assert np.all(np.isfinite(runs["t_losses"]))
    rel = np.abs(runs["t_losses"] - runs["j_losses"]) / np.abs(runs["j_losses"])
    assert np.all(rel <= 1e-4), rel
    for key, value in runs["j_metrics"].items():
        np.testing.assert_allclose(float(runs["tacc"][key][0]), value, rtol=1e-4, err_msg=key)
        assert float(runs["tacc"][key][1]) == N_STEPS


def test_lockstep_updates_match_jax(runs):
    keys = sorted(runs["state0"])
    p0 = _flat(runs["state0"], keys)
    j1, jn = _flat(runs["j_params"][0], keys), _flat(runs["j_params"][-1], keys)
    t1, tn = _flat(runs["t_params"][0], keys), _flat(runs["t_params"][-1], keys)
    assert np.linalg.norm(t1 - p0) > 0
    # under plain SGD the step-1 update is -lr * gradient: the gradient cosine
    assert _cos(t1 - p0, j1 - p0) >= 0.9999
    assert _cos(tn - p0, jn - p0) >= 0.999
    # both networks learn
    for prefix in ("depth_net.", "pose_net."):
        sub = [k for k in keys if k.startswith(prefix)]
        assert np.linalg.norm(_flat(runs["t_params"][0], sub) - _flat(runs["state0"], sub)) > 0


def test_flip_forced_on_and_off_matches_jax(runs):
    batch = prepare_train_batch(runs["batches"][0], "cpu")
    with torch.no_grad():
        off = model_loss(_port_model(runs["state0"]), batch,
                         generator=torch.Generator().manual_seed(0))[0].item()
        on = model_loss(_port_model(runs["state0"], flip_lr_prob=1.0), batch,
                        generator=torch.Generator().manual_seed(0))[0].item()
        no_generator = model_loss(_port_model(runs["state0"], flip_lr_prob=1.0), batch)[0].item()
    np.testing.assert_allclose(off, runs["j_losses"][0], rtol=1e-4)
    np.testing.assert_allclose(on, runs["j_flip"], rtol=1e-4)
    assert abs(on - off) > 1e-6 * abs(off)       # the flip is not a no-op
    assert no_generator == off                   # no generator, no flip


def test_num_scales_override_and_upsampled_depth_maps(runs):
    batch = prepare_train_batch(runs["batches"][0], "cpu")
    model = _port_model(runs["state0"])
    with torch.no_grad():
        four = model_loss(model, batch)[0].item()
        two, (_, out) = model_loss(model, batch, num_scales=2)
        model.upsample_depth_maps = True
        _, (_, up) = model_loss(model, batch)
    assert abs(two.item() - four) > 1e-6 * abs(four)
    assert [tuple(d.shape[1:3]) for d in out["inv_depths"]] == [(H >> i, W >> i) for i in range(4)]
    assert [tuple(d.shape[1:3]) for d in up["inv_depths"]] == [(H, W)] * 4
    np.testing.assert_array_equal(up["inv_depths"][1][:, ::2, ::2].numpy(),
                                  out["inv_depths"][1].numpy())


def test_grad_accum_two_equals_one_step_on_the_whole_batch(runs):
    batches = runs["batches"][:1]
    keys = sorted(runs["state0"])
    p0 = _flat(runs["state0"], keys)
    whole_losses, whole, _ = _sgd_steps(_port_model(runs["state0"]), batches)
    accum_losses, accum, acc = _sgd_steps(_port_model(runs["state0"]), batches, grad_accum=2)
    np.testing.assert_allclose(accum_losses, whole_losses, rtol=1e-5)
    assert float(acc["loss"][1]) == 1           # one optimizer step, one count
    assert _cos(_flat(accum[0], keys) - p0, _flat(whole[0], keys) - p0) >= 0.99999
    with pytest.raises(ValueError, match="microbatches"):
        _sgd_steps(_port_model(runs["state0"]), batches, grad_accum=3)


if __name__ == "__main__":
    # Prints the figures the lockstep's bounds rest on:
    #   PYTHONPATH=. python tests/test_torch_flagship_step.py
    jax.config.update("jax_platforms", "cpu")
    r = _run_both()
    keys = sorted(r["state0"])
    p0 = _flat(r["state0"], keys)
    print("step loss rel", np.abs(r["t_losses"] - r["j_losses"]) / np.abs(r["j_losses"]))
    print("update cosines", [_cos(_flat(a, keys) - p0, _flat(b, keys) - p0)
                             for a, b in zip(r["t_params"], r["j_params"])])
