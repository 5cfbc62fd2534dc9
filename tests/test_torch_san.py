"""PackNet-SAN in the port against the JAX package: the sparse lidar branch
(``nn/sparse.py``), PackNetSAN01 (``nn/packnet_san.py``) and the
SemiSupCompletionModel train and eval steps, on the same weights (carried
by ``utils/convert.from_jax``) and seeded inputs, float32 on the CPU at
64x96, batch 2, unless a case says otherwise.

Tolerances, and what was measured on a CPU (``PYTHONPATH=. python
tests/test_torch_san.py`` prints the figures):
- the masked max pool: exact (a max picks an input), on odd and even
  sizes; MaskedBatchNorm and PackNetSAN01 in eval (rgb, and rgb + input
  depth) and in train (the dual pass, its two inverse-depth lists and
  ``depth_loss``): rtol 1e-4 / atol 1e-5, the whole network's tolerance of
  tests/test_torch_packnet.py (measured at most 4.1e-6 absolute); the
  SparseDepthEncoder (train, with the running statistics it moves, and
  eval): 1e-4 of each level's largest magnitude (measured 6.7e-6 at the
  deepest level in training, whose batch statistics come from a few active
  sites);
- the eval step's per-sample rows against JAX's ``make_eval_step`` with and
  without input depth, as tests/test_torch_eval.py holds them: continuous
  metrics rtol 1e-3 / atol 1e-4 (measured 1.9e-6), a1-a3 within 2 /
  n_valid (measured equal), the post-processed inverse depth rtol 1e-4
  (5.8e-6); and the flip of the eval step mirrors the input depth (a
  mirrored batch gives the mirrored prediction, atol 1e-5, as JAX's
  tests/test_completion_eval.py holds JAX; measured equal, and 1.9e-6 on
  the rows);
- the JAX package cannot differentiate through its sparse branch: its
  masked max pool has no reverse-mode rule (ROADMAP.md §3 (n), pinned
  here), so it cannot train PackNet-SAN with input depth. The reference
  train steps here run it with a stand-in pool of the same values whose
  gradient XLA knows (``_differentiable_pool``: values and gradient equal
  to the port's pool exactly);
- a SemiSupCompletionModel train step in lockstep, plain SGD at lr 1e-2 as
  tests/test_lockstep.py, 3 steps: per-step loss and each term
  (supervised_loss, supervised_loss_rgbd, depth_loss) rtol 1e-4 (measured
  8.3e-7 and 1.0e-6); the step-1 update cosine, which under SGD is the
  gradient cosine, >= 0.9999 (measured 0.99999991), and over 3 steps
  >= 0.999 (0.9999990); the running statistics after 3 steps within
  1e-3 of their largest (measured 1.1e-4: they follow weights that the
  steps' rounding has moved apart);
- the bfloat16 policy: JAX builds PackNetSAN01 without a dtype, so its
  layers compute in float32; but its bfloat16 step cannot run, since the
  sparse branch's pool meets a bfloat16 mask with a float32
  ``reduce_window`` initial value and raises (ROADMAP.md §3 (m), pinned
  here). The port computes what JAX's dtype-less layers would: float32 on
  the rgb and input depth rounded to bfloat16, the target in float32 (§3
  (l)). Its bfloat16 step's loss against JAX's float32 loss on the rounded
  batch: rtol 1e-5 (measured 8.5e-8); and against its own float32 model on
  that batch: bit for bit;
- two gloo ranks of a SparseDepthEncoder's training forward, each on half
  of a global batch of 4 depth maps of different densities, against JAX's
  forward on the whole batch: features rtol 1e-4 / atol 1e-5, running
  statistics within 1e-4 of their largest, the ranks' summed gradients
  within 1e-4 of the largest gradient;
  the control with each rank's own statistics is far outside.
"""

import os
import pathlib
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine.factory import setup_metrics_config as jax_metrics_config
from packnet_sfm_tpu.engine.train import TrainState, _cast_tree
from packnet_sfm_tpu.engine.train import make_eval_step as jax_make_eval_step
from packnet_sfm_tpu.engine.train import make_train_step as jax_make_train_step
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.models.sfm import model_loss as jax_model_loss
from packnet_sfm_tpu.nn import sparse as jsparse
from packnet_sfm_tpu.nn.packnet_san import PackNetSAN01 as JaxPackNetSAN01
from packnet_sfm_tpu.parallel.mesh import make_mesh, shard_batch
from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.engine.factory import setup_metrics_config, setup_model
from packnet_sfm_tpu_torch.engine.train import (
    cast_batch,
    make_eval_step,
    make_train_step,
    prepare_train_batch,
    zero_metrics,
)
from packnet_sfm_tpu_torch.engine import metrics as tm
from packnet_sfm_tpu_torch.models.sfm import model_loss
from packnet_sfm_tpu_torch.nn import sparse
from packnet_sfm_tpu_torch.nn.packnet_san import PackNetSAN01
from packnet_sfm_tpu_torch.ops.image import flip_lr
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
RTOL, ATOL = 1e-4, 1e-5
B, H, W = 2, 64, 96
N_STEPS, LR = 3, 1e-2
LAUNCH_TIMEOUT = 120


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _close(ours, theirs, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(theirs, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def _flat(state: dict, keys) -> np.ndarray:
    # concatenated in float32 by torch, then widened: ten times numpy's per-key widening
    return torch.cat([torch.as_tensor(state[k]).reshape(-1) for k in keys]).double().numpy()


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _smooth(rng, b=B, h=H, w=W):
    """Low-res noise, bilinear-upsampled x8 (NHWC), as tests/test_lockstep.py."""
    base = torch.from_numpy(rng.uniform(size=(b, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def _depths(rng, b=B, h=H, w=W, gt_density=0.5, input_density=0.1):
    """A smooth depth in [5, 75] m; the ground truth on gt_density of the
    pixels, the input depth on input_density of them."""
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    depth = 5.0 + 70.0 * (1.0 - ys / h) ** 2 + 3.0 * np.sin(xs / 9.0)
    depth = np.broadcast_to(depth[None, ..., None], (b, h, w, 1)) * rng.uniform(
        0.8, 1.2, size=(b, 1, 1, 1))
    gt = depth * (rng.uniform(size=depth.shape) < gt_density)
    inp = depth * (rng.uniform(size=depth.shape) < input_density)
    return gt.astype(np.float32), inp.astype(np.float32)


def _batch(seed):
    rng = np.random.default_rng(seed)
    gt, inp = _depths(rng)
    return {"rgb": _smooth(rng), "depth": gt, "input_depth": inp}


def _differentiable_pool(x, mask, window=3, stride=2):
    """The JAX package's ``masked_max_pool`` with the same values, written
    so that XLA knows its gradient: its own runs ``reduce_window`` with
    ``jax.lax.max`` from the dtype's lowest finite value, a reduction with
    no reverse-mode rule, so that ``jax.grad`` through the sparse branch
    raises (ROADMAP.md §3 (n), pinned below); from -inf the same reduction
    is XLA's max pool, whose gradient goes to the window's largest entry, as
    PyTorch's does. The reference train steps of this file run with it."""
    p = window // 2
    dims, strides = (1, window, window, 1), (1, stride, stride, 1)
    pad = ((0, 0), (p, p), (p, p), (0, 0))
    xm = jnp.where(mask > 0, x, jnp.finfo(x.dtype).min)
    pooled = jax.lax.reduce_window(xm, -jnp.inf, jax.lax.max, dims, strides, pad)
    new_mask = jax.lax.reduce_window(mask, -jnp.inf, jax.lax.max, dims, strides, pad)
    return jnp.where(new_mask > 0, pooled, 0.0), new_mask


# --- the sparse branch ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(13, 18), (16, 24)])
def test_masked_max_pool_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, *shape, 4)).astype(np.float32)
    mask = (rng.uniform(size=(B, *shape, 1)) < 0.2).astype(np.float32)
    jp, jm = jsparse.masked_max_pool(jnp.asarray(x), jnp.asarray(mask))
    tp, tmask = sparse.masked_max_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                       torch.from_numpy(mask).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(tp.permute(0, 2, 3, 1).numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tmask.permute(0, 2, 3, 1).numpy(), np.asarray(jm))
    # the tests' differentiable stand-in gives the same values, and a
    # gradient, where the JAX package's pool has none
    dp, dm = _differentiable_pool(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(dp), np.asarray(jp))
    np.testing.assert_array_equal(np.asarray(dm), np.asarray(jm))
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda v: jsparse.masked_max_pool(v, jnp.asarray(mask))[0].sum())(
            jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    sparse.masked_max_pool(xt, torch.from_numpy(mask).permute(0, 3, 1, 2))[0].sum().backward()
    want = jax.grad(lambda v: _differentiable_pool(v, jnp.asarray(mask))[0].sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_masked_batch_norm_matches_jax(train):
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, size=(B, 9, 11, 6)).astype(np.float32)
    mask = (rng.uniform(size=(B, 9, 11, 1)) < 0.3).astype(np.float32)
    net = jsparse.MaskedBatchNorm()
    params = {"scale": rng.normal(size=6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=6).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats}
    port = sparse.MaskedBatchNorm(6)
    port.load_state_dict(from_jax(params, stats), strict=True)
    port.train(train)
    xt, mt = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, mask))
    if train:
        want, upd = net.apply(variables, x, mask, train=True, mutable=["batch_stats"])
    else:
        want = net.apply(variables, x, mask, train=False)
    got = port(xt, mt).permute(0, 2, 3, 1)
    _close(got, want)
    if train:
        new = port.state_dict()
        for key, value in from_jax({}, _np(upd["batch_stats"])).items():
            _close(new[key], value.numpy(), key)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sparse_depth_encoder_matches_jax(train):
    _, inp = _depths(np.random.default_rng(2))
    channels = (32, 64, 128, 256, 512)
    net = jsparse.SparseDepthEncoder(channels=channels)
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(2), inp)
    port = sparse.SparseDepthEncoder(channels)
    port.load_state_dict(from_jax(_np(variables["params"]), _np(variables["batch_stats"])),
                         strict=True)
    port.train(train)
    if train:
        want, upd = jax.jit(partial(net.apply, train=True, mutable=["batch_stats"]))(
            variables, inp)
    else:
        want = jax.jit(partial(net.apply, train=False))(variables, inp)
    got = port(torch.from_numpy(inp).permute(0, 3, 1, 2))
    assert len(got) == len(channels)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.permute(0, 2, 3, 1).shape) == w.shape
        # in training the deepest levels normalize by the statistics of a
        # few active sites, which amplifies rounding: a share of the largest
        _close(g.permute(0, 2, 3, 1), w, f"level {i}", rtol=0,
               atol=RTOL * float(np.abs(np.asarray(w)).max()))
    if train:
        new = port.state_dict()
        for key, value in from_jax({}, _np(upd["batch_stats"])).items():
            _close(new[key], value.numpy(), key)


# --- PackNetSAN01 ---------------------------------------------------------------

def _san_setup():
    batch = _batch(3)
    net = JaxPackNetSAN01()
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(0), batch["rgb"],
                                                      batch["input_depth"])
    state = from_jax(_np(variables["params"]), _np(variables["batch_stats"]))
    return batch, net, variables, state


@pytest.fixture(scope="module")
def san():
    return _san_setup()


@pytest.mark.parametrize("case", ["eval-rgb", "eval-rgbd", "train-rgb", "train-rgbd"])
def test_packnet_san_matches_jax(san, case):
    batch, net, variables, state = san
    train, with_depth = case.startswith("train"), case.endswith("rgbd")
    port = PackNetSAN01()
    port.load_state_dict(state, strict=True)
    port.train(train)
    args = [batch["rgb"], batch["input_depth"] if with_depth else None]
    if train:
        want, upd = jax.jit(partial(net.apply, train=True, mutable=["batch_stats"]))(
            variables, *args)
    else:
        want = jax.jit(partial(net.apply, train=False))(variables, *args)
    got = port(*[None if a is None else torch.from_numpy(a) for a in args])
    assert set(got) == set(want)
    for key in want:
        if key == "depth_loss":
            _close(got[key], want[key], key, rtol=1e-5, atol=0)
            continue
        assert len(got[key]) == 4
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            _close(g, w, f"{key} {i}")
    if train and with_depth:
        new = port.state_dict()
        for key, value in from_jax({}, _np(upd["batch_stats"])).items():
            _close(new[key], value.numpy(), key)
        assert set(want) == {"inv_depths", "inv_depths_rgbd", "depth_loss"}


def _configs(crop="garg"):
    cfg = jax_default_config()
    cfg.model.name = "SemiSupCompletionModel"
    cfg.model.depth_net.name = "PackNetSAN01"
    cfg.model.depth_net.version = "1A"
    cfg.model.pose_net.name = "PoseNet"
    cfg.model.loss.supervised_loss_weight = 1.0
    cfg.model.loss.flip_lr_prob = 0.0
    cfg.model.params.crop = crop
    return cfg, ConfigNode.from_dict(cfg.to_dict())


def _models(state, crop="garg"):
    jcfg, tcfg = _configs(crop)
    jmodel = jax_factory.setup_model(jcfg.model)
    model = setup_model(tcfg.model, device="cpu")
    model.load_state_dict({"depth_net." + k: v for k, v in state.items()}, strict=True)
    return jcfg, tcfg, jmodel, model


def _n_valid(gt):
    valid = (gt[..., 0] > 0) & (gt[..., 0] < 80) & (tm.garg_crop_mask(*gt.shape[1:3]).numpy() > 0)
    return int(valid.reshape(len(gt), -1).sum(axis=1).min())


@pytest.mark.parametrize("with_depth", [False, True], ids=["rgb", "rgbd"])
def test_eval_step_rows_match_jax(san, with_depth):
    batch, _, variables, state = san
    jcfg, tcfg, jmodel, model = _models(state)
    assert jmodel.pose_net is None and model.pose_net is None
    ebatch = {k: v for k, v in batch.items() if with_depth or k != "input_depth"}
    jstate = TrainState.create({"params": {"depth_net": variables["params"]},
                                "batch_stats": {"depth_net": variables["batch_stats"]}},
                               optax.sgd(LR))
    want = jax_make_eval_step(jmodel, make_mesh(num_devices=1),
                              jax_metrics_config(jcfg))(jstate, ebatch)
    got = make_eval_step(model, setup_metrics_config(tcfg))(ebatch)
    n_valid = _n_valid(batch["depth"])
    for mode in ("depth", "depth_pp", "depth_gt", "depth_pp_gt"):
        g, w = got[mode].numpy(), np.asarray(want[mode])
        np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=1e-3, atol=1e-4, err_msg=mode)
        np.testing.assert_allclose(g[..., 4:], w[..., 4:], rtol=0, atol=2.0 / n_valid)
    _close(got["inv_depth"], want["inv_depth"], rtol=1e-4, atol=0)


def test_eval_flip_mirrors_input_depth(san):
    """A mirrored batch (rgb, input depth and ground truth) gives the mirrored
    post-processed prediction, and the input depth reaches the graph."""
    batch, _, _, state = san
    _, tcfg, _, model = _models(state, crop="")     # the Garg crop is not mirror-symmetric
    step = make_eval_step(model, setup_metrics_config(tcfg))
    out = step(batch)
    mirrored = {k: np.ascontiguousarray(v[:, :, ::-1]) for k, v in batch.items()}
    out_m = step(mirrored)
    _close(out_m["inv_depth"], flip_lr(out["inv_depth"]).numpy(), rtol=0, atol=1e-5)
    _close(out_m["depth_pp"], out["depth_pp"].numpy(), rtol=0, atol=1e-4)
    rgb_only = step({k: v for k, v in batch.items() if k != "input_depth"})
    assert float((rgb_only["inv_depth"] - out["inv_depth"]).abs().max()) > 1e-6


# --- the train step in lockstep ---------------------------------------------------

def _run_lockstep(variables, state0):
    """3 SGD steps of the SemiSupCompletionModel in both packages from the
    same weights on the same batches."""
    jcfg, tcfg, jmodel, model = _models(state0)
    batches = [_batch(10 + i) for i in range(N_STEPS)]
    # the port's steps run in a thread while XLA compiles JAX's (both
    # release the interpreter while they compute)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_lockstep, model, batches)
        j_losses, j_states, j_terms = _jax_lockstep(jmodel, variables, batches)
        t_losses, t_states, tacc = port.result()
    t_terms = {k: float(tacc[k][0]) for k in j_terms}
    return dict(j_losses=np.array(j_losses), t_losses=np.array(t_losses), j_terms=j_terms,
                t_terms=t_terms, j_states=j_states, t_states=t_states,
                state0={"depth_net." + k: v for k, v in state0.items()})


def _jax_lockstep(jmodel, variables, batches):
    tx = optax.sgd(LR)
    mesh = make_mesh(num_devices=1)
    # copies: the JAX step donates its state's buffers
    copy = partial(jax.tree_util.tree_map, jnp.array)
    # committed to the mesh as the step returns them: from uncommitted ones
    # its first call would compile a second program (the same numbers)
    jstate, acc = jax.device_put(
        (TrainState.create({"params": {"depth_net": copy(variables["params"])},
                            "batch_stats": {"depth_net": copy(variables["batch_stats"])}}, tx),
         jax_zero_metrics()), NamedSharding(mesh, PartitionSpec()))
    jstep = jax_make_train_step(jmodel, tx, mesh)
    j_losses, j_states, prev = [], [], 0.0
    for b in batches:
        jstate, acc = jstep(jstate, acc, shard_batch(b, mesh), progress=0.0)
        cum = float(acc["loss"][0])
        j_losses.append(cum - prev)
        prev = cum
        j_states.append(from_jax(_np(jstate.params), _np(jstate.batch_stats)))
    j_terms = {k: float(acc[k][0]) for k in ("supervised_loss", "supervised_loss_rgbd",
                                             "depth_loss")}
    return j_losses, j_states, j_terms


def _port_lockstep(model, batches):
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    tacc = zero_metrics("cpu")
    t_losses, t_states, prev = [], [], 0.0
    for b in batches:
        tacc = step(tacc, b, 0.0)
        cum = float(tacc["loss"][0])
        t_losses.append(cum - prev)
        prev = cum
        t_states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    return t_losses, t_states, tacc


def _update_cosines(runs):
    """(step-1, step-N) cosines of the port's weight update against JAX's."""
    keys = sorted(k for k in runs["state0"] if "running" not in k)
    p0 = _flat(runs["state0"], keys)
    j1, jn = (_flat(runs["j_states"][i], keys) for i in (0, -1))
    t1, tn = (_flat(runs["t_states"][i], keys) for i in (0, -1))
    return _cos(t1 - p0, j1 - p0), _cos(tn - p0, jn - p0)


@pytest.fixture(scope="module")
def lockstep(san):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsparse, "masked_max_pool", _differentiable_pool)
        return _run_lockstep(san[2], san[3])


def test_lockstep_losses_match_jax(lockstep):
    assert np.all(np.isfinite(lockstep["t_losses"]))
    rel = np.abs(lockstep["t_losses"] - lockstep["j_losses"]) / np.abs(lockstep["j_losses"])
    assert np.all(rel <= 1e-4), rel
    for key, value in lockstep["j_terms"].items():
        np.testing.assert_allclose(lockstep["t_terms"][key], value, rtol=1e-4, err_msg=key)


def test_lockstep_updates_match_jax(lockstep):
    keys = sorted(k for k in lockstep["state0"] if "running" not in k)
    first, last = _update_cosines(lockstep)
    assert first >= 0.9999 and last >= 0.999, (first, last)
    # the sparse branch and the level weights learn
    for part in ("depth_net.mconvs.", "depth_net.weight"):
        sub = [k for k in keys if k.startswith(part)]
        assert np.linalg.norm(_flat(lockstep["t_states"][0], sub)
                              - _flat(lockstep["state0"], sub)) > 0
    for key in (k for k in lockstep["state0"] if "running" in k):
        want = lockstep["j_states"][-1][key].numpy()
        np.testing.assert_allclose(lockstep["t_states"][-1][key].numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(), err_msg=key)


# --- the bfloat16 policy --------------------------------------------------------

def test_bfloat16_san_computes_as_jax_does(san):
    batch, _, variables, state = san
    _, tcfg, jmodel, _ = _models(state)
    jvars = {"params": {"depth_net": variables["params"]},
             "batch_stats": {"depth_net": variables["batch_stats"]}}
    with pytest.raises(TypeError, match="reduce_window"):
        jax.jit(lambda v, b: jax_model_loss(jmodel, v, _cast_tree(b, jnp.bfloat16))[0])(
            jvars, batch)
    rounded = dict(batch)
    for key in ("rgb", "input_depth"):
        rounded[key] = np.asarray(jnp.asarray(batch[key], jnp.bfloat16).astype(jnp.float32))
    want = float(jax.jit(lambda v, b: jax_model_loss(jmodel, v, b)[0])(jvars, rounded))

    losses = {}
    for dtype, source in ((torch.bfloat16, batch), (None, rounded)):
        model = setup_model(tcfg.model, device="cpu", dtype=dtype)
        model.load_state_dict({"depth_net." + k: v for k, v in state.items()}, strict=True)
        prepared = prepare_train_batch(source, "cpu")
        if dtype is not None:
            prepared = cast_batch(prepared, dtype)
            assert prepared["input_depth"].dtype == torch.bfloat16
            assert prepared["depth"].dtype == torch.float32
        loss, (_, out) = model_loss(model, prepared)
        assert all(d.dtype == torch.float32 for d in out["inv_depths_rgbd"])
        losses[dtype] = loss
    np.testing.assert_allclose(float(losses[torch.bfloat16]), want, rtol=1e-5)
    assert torch.equal(losses[torch.bfloat16], losses[None])


# --- MaskedBatchNorm over two ranks ------------------------------------------------

def test_two_ranks_masked_batch_norm_matches_jax_on_the_global_batch(tmp_path, monkeypatch):
    monkeypatch.setattr(jsparse, "masked_max_pool", _differentiable_pool)
    rng = np.random.default_rng(21)
    depth = np.concatenate([_depths(rng, input_density=d)[1] for d in (0.05, 0.3)])  # [4, ...]
    channels = (8, 16)
    net = jsparse.SparseDepthEncoder(channels=channels)
    variables = jax.jit(partial(net.init, train=True))(jax.random.PRNGKey(4), depth)
    feats, upd = jax.jit(partial(net.apply, train=True, mutable=["batch_stats"]))(variables,
                                                                               depth)
    weights = {f"w{i}": rng.normal(size=f.shape).astype(np.float32) for i, f in enumerate(feats)}

    def loss_fn(params):
        out, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, depth,
                           train=True, mutable=["batch_stats"])
        return sum(jnp.sum(f * weights[f"w{i}"]) for i, f in enumerate(out))

    grads = from_jax(_np(jax.jit(jax.grad(loss_fn))(variables["params"])))
    stats = from_jax({}, _np(upd["batch_stats"]))
    np.savez(tmp_path / "depth.npz", depth=depth)
    np.savez(tmp_path / "weights.npz", **weights)
    torch.save(from_jax(_np(variables["params"]), _np(variables["batch_stats"])),
               tmp_path / "state0.pt")

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", os.path.join(ROOT, "tests", "torch_san_worker.py"), str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the two-rank launch did not finish in {LAUNCH_TIMEOUT} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    def errors(kind):
        feat = max(float(np.max(np.abs(torch.cat([r[kind]["feats"][i] for r in ranks]).numpy()
                                       - np.asarray(f)) / (np.abs(np.asarray(f)).max())))
                   for i, f in enumerate(feats))
        stat = max(float((ranks[0][kind]["stats"][k] - v).abs().max() / v.abs().max())
                   for k, v in stats.items())
        # of the largest gradient: a conv bias ahead of a batch norm has a
        # gradient of rounding size only
        scale = max(float(v.abs().max()) for v in grads.values())
        grad = max(float((ranks[0][kind]["grads"][k] - v).abs().max()) for k, v in grads.items())
        return feat, stat, grad / scale

    for i, f in enumerate(feats):
        _close(torch.cat([r["global"]["feats"][i] for r in ranks]), f, f"level {i}")
    feat, stat, grad = errors("global")
    assert stat <= 1e-4 and grad <= 1e-4, (stat, grad)
    for key in grads:
        assert torch.equal(ranks[0]["global"]["grads"][key], ranks[1]["global"]["grads"][key])
    local = errors("local")
    assert local[1] > 1e-2 and local[2] > 1e-2, local


if __name__ == "__main__":
    batch, net, variables, state = _san_setup()
    jsparse.masked_max_pool = _differentiable_pool
    runs = _run_lockstep(variables, state)
    print("lockstep per-step loss, relative:",
          np.abs(runs["t_losses"] - runs["j_losses"]) / np.abs(runs["j_losses"]))
    print("terms, relative:", {k: abs(runs["t_terms"][k] - v) / abs(v)
                               for k, v in runs["j_terms"].items()})
    print("update cosines (step 1, step 3):", _update_cosines(runs))
