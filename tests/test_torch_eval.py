"""The whole slice: the eval protocol of the port's ``Trainer.validate``
against the JAX package's on the same weights (SelfSupModel with
PackNetSlim01-1A standing in for PackNet01 at test size, 64x96, the Garg
crop, a Synthetic validation split of 13 samples in batches of 8, so that
the last batch is padded), and the flip-fused eval step against JAX's for
PackNetSlim01 and for RaySurfaceResNet-18 with non-trivial BatchNorm
running statistics; float32 on the CPU.

Tolerances, and what was measured on a CPU:
- continuous metrics (abs_rel, sqr_rel, rmse, rmse_log), whole network:
  rtol 1e-3, atol 1e-4, the whole-network tolerance of
  tests/test_torch_packnet.py (measured: validate 1.7e-6 relative; eval
  step rows, PackNetSlim01 1.1e-5, RaySurfaceResNet 1.2e-6);
- a1-a3: within 2 / n_valid, n_valid the fewest valid pixels of a sample (a
  pixel whose ratio sits on a threshold may flip; measured 0);
- the post-processed inverse depth: rtol 1e-4 (measured 1.3e-5 for
  PackNetSlim01, 6.8e-7 for RaySurfaceResNet);
- the port's protocol against its own every-sample oracle at B = 1: atol
  2e-4, as tests/test_eval_protocol.py holds the JAX package (measured
  5.1e-6).
"""

import itertools

import jax
import numpy as np
import optax
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import merge_config as jax_merge_config
from packnet_sfm_tpu.core.config import parse_train_config as jax_parse_train_config
from packnet_sfm_tpu.engine import factory as jax_factory
from packnet_sfm_tpu.engine import metrics as jm
from packnet_sfm_tpu.engine.train import TrainState
from packnet_sfm_tpu.engine.train import make_eval_step as jax_make_eval_step
from packnet_sfm_tpu.engine.trainer import Trainer as JaxTrainer
from packnet_sfm_tpu.engine.trainer import _device_batch
from packnet_sfm_tpu.models.sfm import init_model
from packnet_sfm_tpu.parallel.mesh import make_mesh, shard_batch
from packnet_sfm_tpu_torch.core.config import OMNICAM, ConfigNode, config_from_dict
from packnet_sfm_tpu_torch.core.config import parse_train_config
from packnet_sfm_tpu_torch.datasets.loader import DataLoader
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
from packnet_sfm_tpu_torch.engine import metrics as tm
from packnet_sfm_tpu_torch.engine.factory import setup_model
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, make_eval_step
from packnet_sfm_tpu_torch.engine.trainer import Trainer
from packnet_sfm_tpu_torch.models.sfm import model_forward
from packnet_sfm_tpu_torch.utils.convert import from_jax

torch.set_num_threads(1)

ODD_LENGTH, BATCH, H, W = 13, 8, 64, 96
RTOL, ATOL = 1e-3, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _jax_config():
    c = jax_default_config()
    c.model.name = "SelfSupModel"
    c.model.depth_net.name = "PackNetSlim01"
    c.model.depth_net.version = "1A"
    c.model.pose_net.name = "PoseNet"
    c.model.params.crop = "garg"
    for mode in ("train", "validation", "test"):
        d = c.datasets[mode]
        d.dataset = ["Synthetic"]
        d.path = [""]
        d.split = [""]
        d.depth_type = [""]
        d.batch_size = BATCH
        d.num_workers = 1
        d.synthetic_length = ODD_LENGTH
        d.synthetic_height = H
        d.synthetic_width = W
    return jax_parse_train_config(c)


def _n_valid(gt, crop="garg"):
    """Fewest valid pixels of a sample in gt [B, H, W, 1]."""
    valid = (gt[..., 0] > 0) & (gt[..., 0] < 80)
    if crop == "garg":
        valid = valid & (tm.garg_crop_mask(*gt.shape[1:3]).numpy() > 0)
    return int(valid.reshape(len(gt), -1).sum(axis=1).min())


def _assert_rows_close(got, want, n_valid):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=2.0 / n_valid)


@pytest.fixture(scope="module")
def trainers():
    jcfg = _jax_config()
    jt = JaxTrainer(jcfg)
    jt.init_state(next(iter(jt.train_loaders[0].epoch(0))))
    pt = Trainer(parse_train_config(ConfigNode.from_dict(jcfg.to_dict())), device="cpu")
    pt.model.load_state_dict(from_jax(_np_tree(jt.state.params),
                                      _np_tree(jt.state.batch_stats)))
    return jt, pt


@pytest.fixture(scope="module")
def validated(trainers):
    jt, pt = trainers
    return jt.validate(0), pt.validate(0)


def test_validate_matches_jax(trainers, validated):
    want, got = validated
    _, pt = trainers
    gt = np.stack([pt.val_datasets[0][i]["depth"] for i in range(ODD_LENGTH)])
    assert len(got) == len(want) == 1
    for mode in EVAL_MODES:
        assert got[0][mode].shape == (7,) and np.all(np.isfinite(got[0][mode]))
        _assert_rows_close(got[0][mode], want[0][mode], _n_valid(gt))
    assert np.abs(got[0]["depth_pp_gt"] - got[0]["depth"]).max() > 1e-3


def test_eval_step_matches_jax_packnet(trainers):
    jt, pt = trainers
    batch = next(iter(pt.val_loaders[0].epoch(0)))
    want = jt.eval_step(jt.state, shard_batch(_device_batch(batch), jt.mesh))
    got = pt.eval_step(batch)
    for mode in EVAL_MODES:
        assert got[mode].shape == (BATCH, 7)
        _assert_rows_close(got[mode].numpy(), want[mode], _n_valid(batch["depth"]))
    np.testing.assert_allclose(got["inv_depth"].numpy(), np.asarray(want["inv_depth"]),
                               rtol=1e-4)


def test_eval_step_matches_jax_raysurface():
    """RaySurfaceResNet-18 at 64x64: BatchNorm normalizes with its running
    statistics, which are given values far from (0, 1) first; the ground
    truth is at another resolution (48x80) than the input."""
    ds = SyntheticSfmDataset(length=2, height=64, width=64, seed=5)
    gt_ds = SyntheticSfmDataset(length=2, height=48, width=80, seed=6, back_context=0,
                                forward_context=0)
    batch = {"rgb": np.stack([ds[i]["rgb"] for i in range(2)]),
             "depth": np.stack([gt_ds[i]["depth"] for i in range(2)]),
             "intrinsics": np.stack([ds[i]["intrinsics"] for i in range(2)])}
    init_batch = {"rgb": batch["rgb"],
                  "rgb_context": [np.stack([ds[i]["rgb_context"][c] for i in range(2)])
                                  for c in range(2)]}
    jcfg = jax_merge_config(jax_default_config(), OMNICAM)
    jmodel = jax_factory.setup_model(jcfg.model)
    variables = _np_tree(init_model(jmodel, jax.random.PRNGKey(0), init_batch))
    rng = np.random.default_rng(7)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 2.0, v.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.2, v.shape)).astype(np.float32),
        variables["batch_stats"])
    cfg = dict(crop="garg", min_depth=0.0, max_depth=80.0, scale_output="resize")
    jstep = jax_make_eval_step(jmodel, make_mesh(num_devices=1), jm.DepthMetricsConfig(**cfg))
    want = jstep(TrainState.create(variables, optax.identity()), batch)

    model = setup_model(config_from_dict(OMNICAM).model, device="cpu")
    model.load_state_dict(from_jax(variables["params"], variables["batch_stats"]))
    got = make_eval_step(model, tm.DepthMetricsConfig(**cfg))(batch)
    assert not model.training
    for mode in EVAL_MODES:
        _assert_rows_close(got[mode].numpy(), want[mode], _n_valid(batch["depth"]))
    np.testing.assert_allclose(got["inv_depth"].numpy(), np.asarray(want["inv_depth"]),
                               rtol=1e-4)
    # the running statistics matter: the batch's statistics give other depths
    with torch.no_grad():
        train_mode = model_forward(model, {"rgb": torch.from_numpy(batch["rgb"])},
                                   train=True)["inv_depths"][0]
    assert (train_mode - got["inv_depth"]).abs().max() > 1e-3


def test_validate_matches_every_sample_oracle(trainers, validated):
    _, pt = trainers
    _, got = validated
    ds = pt.val_datasets[0]
    rows = {m: np.zeros((ODD_LENGTH, 7)) for m in EVAL_MODES}
    for i in range(ODD_LENGTH):
        s = ds[i]
        out = pt.eval_step({"rgb": s["rgb"][None], "depth": s["depth"][None]})
        for m in rows:
            rows[m][i] = out[m].numpy()[0]
    for m in rows:
        np.testing.assert_allclose(got[0][m], rows[m].mean(axis=0), atol=2e-4, err_msg=m)


def test_validate_masks_the_pad_rows(trainers):
    _, pt = trainers
    plan = pt.val_loaders[0]._batch_plan(0)
    assert [pad for _, pad in plan] == [0, BATCH - ODD_LENGTH % BATCH]
    assert sorted(np.concatenate([idx[:len(idx) - pad] for idx, pad in plan])) == \
        list(range(ODD_LENGTH))


def test_multi_camera_rows_are_averaged(trainers, validated):
    """Two rows a sample (one per camera) are averaged into one."""
    _, pt = trainers
    _, got = validated
    step = pt.eval_step

    def two_cameras(batch):
        out = step(batch)
        return {k: torch.stack([v, 3.0 * v], dim=1).flatten(0, 1) if k in EVAL_MODES else v
                for k, v in out.items()}

    pt.eval_step = two_cameras
    try:
        doubled = pt.validate(0)
    finally:
        pt.eval_step = step
    for m in EVAL_MODES:
        np.testing.assert_allclose(doubled[0][m], 2.0 * got[0][m], rtol=1e-6)


def test_seen_count_assertion_fires_on_gap(trainers):
    _, pt = trainers
    loader = pt.val_loaders[0]
    orig_epoch = loader.epoch
    loader.epoch = lambda e: itertools.islice(orig_epoch(e), 1)
    try:
        with pytest.raises(AssertionError, match="Not all samples"):
            pt.validate(0)
    finally:
        loader.epoch = orig_epoch


def test_depthless_eval_raises(trainers):
    _, pt = trainers
    ds = SyntheticSfmDataset(length=8, height=32, width=64, with_depth=False)
    loader = DataLoader(ds, batch_size=8, shuffle=False, drop_last=False, num_workers=1)
    with pytest.raises(ValueError, match="no ground-truth depth"):
        pt.validate(0, loaders=[loader])
