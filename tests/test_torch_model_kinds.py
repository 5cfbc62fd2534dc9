"""The model kinds and their losses in the port against the JAX package, on
the same weights and seeded inputs, float32 on the CPU:

- the supervised loss, all ten methods (l1, mse, berhu, silog, abs_rel,
  each with and without the ``sparse-`` prefix) over 4 scales, and with 2
  supervised scales; ``depth2inv``; the velocity loss: rtol 1e-5, the JAX
  suite's own parity tolerance (docs/PARITY.md; measured at most 6.1e-7,
  the velocity loss equal);
- ``model_loss`` of each kind through the networks (DepthResNet-18 +
  PoseNet at 32x64, batch 2; PackNetSAN01 for the completion kind): the
  loss and each metric rtol 1e-5 (measured at most 3.0e-7): SemiSup at
  w = 0.9 and at w = 1.0 (pose net dropped, no photometric term), VelSup,
  SfmModel and GenericSfmModel (no loss term) and SemiSupCompletion;
- the training flip at ``flip_lr_prob`` = 1 mirrors ``input_depth`` with
  ``rgb``, and flips both inverse-depth lists back: against JAX's flipped
  forward, rtol 1e-4 / atol 1e-5 (the whole network's tolerance; measured
  3.3e-6 absolute);
- the decisions against the JAX package (ROADMAP.md §3): the bfloat16 cast
  keeps the targets ('depth', 'pose_context') in float32, fault (l);
  dropout builds and evaluates (the identity, as in JAX's eval) and
  refuses a training forward, which JAX cannot run either;
- ``scales_used`` counts the supervised scales; a kind without a loss term
  takes a train step that leaves the weights as they were.
"""

from functools import partial

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.train import _cast_tree
from packnet_sfm_tpu.losses import supervised as jsup
from packnet_sfm_tpu.losses.velocity import velocity_loss as jax_velocity_loss
from packnet_sfm_tpu.models import sfm as jsfm
from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.train import (
    cast_batch,
    make_train_step,
    prepare_train_batch,
    zero_metrics,
)
from packnet_sfm_tpu_torch.losses import supervised as tsup
from packnet_sfm_tpu_torch.losses.velocity import velocity_loss
from packnet_sfm_tpu_torch.models import sfm as tsfm
from packnet_sfm_tpu_torch.ops.image import flip_lr
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
NET_RTOL, NET_ATOL = 1e-4, 1e-5
B, H, W = 2, 32, 64


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- the losses -----------------------------------------------------------------

def _predictions(rng, h=H, w=W, n=4):
    return [rng.uniform(0.02, 1.5, size=(B, h >> i, w >> i, 1)).astype(np.float32)
            for i in range(n)]


def _gt_inv(rng, h=H, w=W):
    inv = rng.uniform(0.01, 1.0, size=(B, h, w, 1)).astype(np.float32)
    return (inv * (rng.uniform(size=inv.shape) < 0.3)).astype(np.float32)


METHODS = [f"{p}{m}" for p in ("", "sparse-") for m in ("l1", "mse", "berhu", "silog",
                                                          "abs_rel")]


@pytest.mark.parametrize("scales", [4, 2])
@pytest.mark.parametrize("method", METHODS)
def test_supervised_loss_matches_jax(method, scales):
    rng = np.random.default_rng(METHODS.index(method))
    preds, gt = _predictions(rng), _gt_inv(rng)
    jcfg = jsup.SupervisedLossConfig(supervised_method=method, supervised_num_scales=scales)
    tcfg = tsup.SupervisedLossConfig(supervised_method=method, supervised_num_scales=scales)
    want, jm = jsup.supervised_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt), jcfg)
    got, tm = tsup.supervised_loss([_t(p) for p in preds], _t(gt), tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert set(tm) == set(jm) == {"supervised_loss"}
    with pytest.raises(ValueError, match="Unknown supervised loss"):
        tsup.supervised_loss([_t(p) for p in preds], _t(gt),
                             tsup.SupervisedLossConfig(supervised_method="sparse-l3"))


def test_depth2inv_and_velocity_loss_match_jax():
    rng = np.random.default_rng(11)
    depth = rng.uniform(-1.0, 80.0, size=(B, H, W, 1)).astype(np.float32)
    depth[0, :3, :3] = 0.0
    np.testing.assert_array_equal(tsfm.depth2inv(_t(depth)).numpy(),
                                  np.asarray(jsfm.depth2inv(jnp.asarray(depth))))
    pred = [rng.normal(size=(B, 4, 4)).astype(np.float32) for _ in range(2)]
    gt = [rng.normal(size=(B, 4, 4)).astype(np.float32) for _ in range(2)]
    want, jm = jax_velocity_loss([jnp.asarray(p) for p in pred], [jnp.asarray(g) for g in gt])
    got, tm = velocity_loss([_t(p) for p in pred], [_t(g) for g in gt])
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert set(tm) == set(jm) == {"velocity_loss"}


# --- the kinds through the networks ---------------------------------------------

def _batch(seed=0, h=H, w=W, with_input_depth=False):
    """As the JAX package's tests/test_model_kinds.py builds it, with a
    sparse ground truth, the OXTS-like context poses and, for completion, a
    sparser input depth."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, h, w, 3)).astype(np.float32)
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 40.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2 - 0.5, h / 2 - 0.5, 1.0
    depth = (rng.uniform(size=(B, h, w, 1)) * 60).astype(np.float32)
    depth[depth < 20] = 0.0
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    T[:, 2, 3] = 1.2
    batch = {"rgb": img, "rgb_context": [np.roll(img, 2, 2), np.roll(img, -2, 2)],
             "intrinsics": K, "depth": depth, "pose_context": [T, T * 0.5]}
    if with_input_depth:
        batch["input_depth"] = (depth * (rng.uniform(size=depth.shape) < 0.3)).astype(
            np.float32)
    return batch


KINDS = {
    "SemiSupModel-0.9": dict(name="SemiSupModel", supervised_loss_weight=0.9),
    "SemiSupModel-1.0": dict(name="SemiSupModel", supervised_loss_weight=1.0),
    "SemiSupModel-berhu-2": dict(name="SemiSupModel", supervised_loss_weight=0.5,
                                 supervised_method="sparse-berhu", supervised_num_scales=2),
    "VelSupModel": dict(name="VelSupModel"),
    "SfmModel": dict(name="SfmModel"),
    "GenericSfmModel": dict(name="GenericSfmModel", depth="RaySurfaceResNet"),
    "SemiSupCompletionModel": dict(name="SemiSupCompletionModel", depth="PackNetSAN01",
                                   supervised_loss_weight=0.9, weight_rgbd=0.5),
}


def _configs(kind, flip=0.0):
    """(JAX config.model, the port's copy of it) for a KINDS entry."""
    spec = dict(KINDS[kind])
    cfg = jax_default_config()
    cfg.model.name = spec.pop("name")
    cfg.model.depth_net.name = spec.pop("depth", "DepthResNet")
    cfg.model.depth_net.version = "1A" if "PackNet" in cfg.model.depth_net.name else "18"
    cfg.model.pose_net.name = "PoseNet"
    cfg.model.loss.flip_lr_prob = flip
    for k, v in spec.items():
        cfg.model.loss[k] = v
    return cfg.model, ConfigNode.from_dict(cfg.model.to_dict())


_INITS = {}


def _both(kind, batch, flip=0.0, seed=1):
    """The JAX model of ``kind``, its initial variables at ``batch`` (drawn
    once a module for each network pair and batch ``seed``: the kinds that
    share DepthResNet-18 + PoseNet share them) and the port's model loaded
    from them."""
    jcfg, tcfg = _configs(kind, flip)
    jmodel = jax_factory.setup_model(jcfg)
    nets = (jcfg.depth_net.name, jmodel.pose_net is not None, seed)
    if nets not in _INITS:
        _INITS[nets] = jsfm.init_model(jmodel, jax.random.PRNGKey(0), batch)
    variables = _INITS[nets]
    model = setup_model(tcfg, device="cpu")
    model.load_state_dict(from_jax(_np(variables["params"]),
                                   _np(variables.get("batch_stats", {}))), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_loss_of_each_kind_matches_jax(kind):
    batch = _batch(1, with_input_depth=kind == "SemiSupCompletionModel")
    jmodel, variables, model = _both(kind, batch, seed=1)
    jloss, (jmetrics, _, _) = jax.jit(partial(jsfm.model_loss, jmodel))(variables, batch)
    loss, (metrics, _) = tsfm.model_loss(model, prepare_train_batch(batch, "cpu"))
    assert set(metrics) == set(jmetrics)
    for key in jmetrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-12, err_msg=key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=1e-12)
    name = KINDS[kind]["name"]
    w = KINDS[kind].get("supervised_loss_weight", 0.9)
    dropped = name in ("SemiSupModel", "SemiSupCompletionModel") and w >= 1.0
    assert (model.pose_net is None) == (jmodel.pose_net is None) == dropped
    assert ("photometric_loss" in metrics) == model.photometric_used
    if name in ("SfmModel", "GenericSfmModel"):
        assert float(loss) == 0.0 and not loss.requires_grad


def test_flip_mirrors_input_depth_like_jax():
    """flip_lr_prob = 1: the network sees flip(rgb) and flip(input_depth),
    and both inverse-depth lists come back flipped, as in JAX."""
    batch = _batch(2, with_input_depth=True)
    jmodel, variables, model = _both("SemiSupCompletionModel", batch, flip=1.0, seed=2)
    jout, _ = jax.jit(partial(jsfm.model_forward, jmodel, train=True))(
        variables, batch, rng=jax.random.PRNGKey(3))
    tbatch = prepare_train_batch(batch, "cpu")
    out = tsfm.model_forward(model, tbatch, train=True, generator=torch.Generator())
    for key in ("inv_depths", "inv_depths_rgbd"):
        for o, j in zip(out[key], jout[key]):
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), rtol=NET_RTOL,
                                       atol=NET_ATOL, err_msg=key)
    # and it is the network on the mirrored inputs, mirrored back
    manual = model.depth_net(flip_lr(tbatch["rgb"]), flip_lr(tbatch["input_depth"]))
    for o, m in zip(out["inv_depths_rgbd"], manual["inv_depths_rgbd"]):
        torch.testing.assert_close(o, flip_lr(m), rtol=0, atol=0)


def test_cast_batch_keeps_the_targets_float32():
    """Fault (l): the JAX package's bfloat16 step casts every floating leaf,
    the ground-truth depth too (50.1 m -> 50.0, 70.3 -> 70.5); the port casts
    the network inputs (the images and input_depth) and keeps the targets
    and the intrinsics in float32."""
    batch = _batch(3, with_input_depth=True)
    batch["depth"][0, 0, 0, 0], batch["depth"][0, 0, 1, 0] = 50.1, 70.3
    jcast = _cast_tree(batch, jnp.bfloat16)
    assert float(jcast["depth"][0, 0, 0, 0]) == 50.0
    assert float(jcast["depth"][0, 0, 1, 0]) == 70.5
    assert jcast["pose_context"][0].dtype == jnp.bfloat16
    ours = cast_batch(prepare_train_batch(batch, "cpu"), torch.bfloat16)
    assert ours["rgb_original"] is ours["rgb"]       # no jitter: cast once, shared
    for key in ("rgb", "input_depth"):
        assert ours[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(ours[key].float().numpy(),
                                      np.asarray(jcast[key].astype(jnp.float32)))
    assert all(c.dtype == torch.bfloat16 for c in ours["rgb_context"])
    for key in ("depth", "intrinsics"):
        assert ours[key].dtype == torch.float32
        np.testing.assert_array_equal(ours[key].numpy(), batch[key])
    for got, want in zip(ours["pose_context"], batch["pose_context"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_builds_evaluates_and_refuses_training_like_jax():
    """PackNetSlim01 with dropout 0.5: eval equals JAX's eval (dropout is
    the identity there); a training forward raises in the port, and in the
    JAX package it raises too (model_forward gives flax no dropout rng)."""
    jcfg = jax_default_config()
    jcfg.model.name = "SelfSupModel"
    jcfg.model.depth_net.name = "PackNetSlim01"
    jcfg.model.depth_net.version = "1A"
    jcfg.model.depth_net.dropout = 0.5
    jcfg.model.pose_net.name = "PoseNet"
    jcfg.model.loss.flip_lr_prob = 0.0
    batch = _batch(4, h=64, w=96)
    jmodel = jax_factory.setup_model(jcfg.model)
    variables = jsfm.init_model(jmodel, jax.random.PRNGKey(0), batch)
    with pytest.raises(flax.errors.InvalidRngError):
        jsfm.model_forward(jmodel, variables, batch, train=True)
    model = setup_model(ConfigNode.from_dict(jcfg.model.to_dict()), device="cpu")
    model.load_state_dict(from_jax(_np(variables["params"])), strict=True)
    jout, _ = jax.jit(partial(jsfm.model_forward, jmodel, train=False))(variables, batch)
    out = tsfm.model_forward(model, prepare_train_batch(batch, "cpu"), train=False)
    for o, j in zip(out["inv_depths"], jout["inv_depths"]):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), rtol=NET_RTOL,
                                   atol=NET_ATOL)
    with pytest.raises(RuntimeError, match="JAX package cannot train"):
        tsfm.model_loss(model, prepare_train_batch(batch, "cpu"))


def test_scales_used_counts_the_supervised_scales():
    def scales(kind, num_scales=None, **loss):
        cfg = _configs(kind)[1]
        cfg.depth_net.name, cfg.pose_net.name = "DepthResNet", "PoseNet"
        for k, v in loss.items():
            cfg.loss[k] = v
        return tsfm.scales_used(setup_model(cfg, device="cpu"), num_scales)

    assert scales("SemiSupModel-1.0") == 4
    assert scales("SemiSupModel-1.0", supervised_num_scales=1) == 1
    # at w < 1 the photometric graph reads its scales too
    assert scales("SemiSupModel-0.9", num_scales=2, supervised_num_scales=1) == 2
    assert scales("SemiSupModel-0.9", num_scales=1, supervised_num_scales=3) == 3
    assert scales("VelSupModel", num_scales=2) == 2
    assert scales("SfmModel") == 0


def test_a_kind_without_a_loss_steps_without_moving():
    _, tcfg = _configs("SfmModel")
    model = setup_model(tcfg, device="cpu")
    optimizer, scheduler = make_optimizer(model, tcfg.optimizer, tcfg.scheduler, 10)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, optimizer, scheduler)
    acc = step(zero_metrics("cpu"), _batch(5), 0.0)
    assert float(acc["loss"][0]) == 0.0 and float(acc["loss"][1]) == 1.0
    for key, value in model.state_dict().items():
        if "running" not in key:
            assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("kind", ["SfmModel", "GenericSfmModel"])
def test_a_kind_without_a_loss_is_refused_in_a_process_group(kind, monkeypatch):
    """A loss-less kind takes no backward, which would leave DDP's reducer
    waiting; in a process group its train step is refused before the
    wrapper is built."""
    _, tcfg = _configs(kind)
    model = setup_model(tcfg, device="cpu")
    optimizer, scheduler = make_optimizer(model, tcfg.optimizer, tcfg.scheduler, 10)
    assert not model.has_loss
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(ValueError, match="no loss to train"):
        make_train_step(model, optimizer, scheduler)
