"""The port's DDAD (DGP) reader, its depth cache, the multi-camera batch
fold and the per-camera train transform, against the JAX package's, on the
JAX tests' DGP scene (tests/test_ddad.py: 4 samples of CAMERA_01 and
CAMERA_05 at 32x48 with a 200-point LIDAR cloud each).

- Samples (one camera and two stacked), their intrinsics, poses, context
  frames, context poses and projected depths: equal bit for bit.
- The depth projected from the cloud is cached next to it as
  ``<cloud>.depth_<camera>.npz``: the port reads JAX's cache and JAX reads
  the port's, and each equals a fresh projection.
- ``stack_multicam_batch``: equal, the per-sample jitter rows repeated per
  camera.
- The train loader's transform of a stacked sample: camera by camera, each
  camera equal to that camera alone from the same (seed, epoch, position)
  draw, the cameras sharing one row of jitter factors, which the fold
  repeats. The JAX package stacks one row a camera and its fold repeats
  that stack along the batch axis ([B*N, N, 4]); the port does not copy it
  (``ROADMAP.md`` §3 (k)).
- A two-camera train epoch and validation through the port's ``Trainer``
  on the CPU (effective batch 4 from 2 samples).
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.datasets import ddad as jddad
from packnet_sfm_tpu.datasets.loader import DataLoader as JaxLoader
from packnet_sfm_tpu.datasets.loader import make_transform as jax_make_transform
from packnet_sfm_tpu.models.batch_utils import stack_multicam_batch as jax_stack
from packnet_sfm_tpu_torch.core.config import config_from_dict, parse_train_config
from packnet_sfm_tpu_torch.datasets import ddad
from packnet_sfm_tpu_torch.datasets.loader import DataLoader, make_transform, setup_dataset
from packnet_sfm_tpu_torch.models.batch_utils import stack_multicam_batch
from tests.test_ddad import ddad_root  # noqa: F401 (a fixture)
from tests.test_torch_datasets import _as_read, assert_samples_equal

torch.set_num_threads(1)

CAMS = ["CAMERA_01", "CAMERA_05"]


@pytest.fixture
def fresh_tree(ddad_root, tmp_path):
    """A copy of the scene without any cached depth."""
    def copy_tree(name):
        out = str(tmp_path / name)
        shutil.copytree(ddad_root, out, ignore=shutil.ignore_patterns("*.depth_*"))
        return out
    return copy_tree


def test_geometry_helpers_match_the_jax_package():
    rng = np.random.default_rng(0)
    for _ in range(4):
        q = rng.normal(size=4)
        np.testing.assert_array_equal(ddad._quat_to_rot(*q), jddad._quat_to_rot(*q))
        p = {"translation": dict(zip("xyz", rng.normal(size=3))),
             "rotation": dict(zip(("qw", "qx", "qy", "qz"), q))}
        np.testing.assert_array_equal(ddad._pose_from_json(p), jddad._pose_from_json(p))
    assert np.array_equal(ddad._pose_from_json({}), np.eye(4))
    points = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    points[:, 2] = rng.uniform(-1, 30, size=500)
    T = ddad._pose_from_json({"translation": {"x": 0.3}, "rotation": {"qw": 1, "qz": 0.05}})
    K = np.array([[30.0, 0, 24], [0, 30, 16], [0, 0, 1]], np.float32)
    ours = ddad.project_pointcloud_to_depth(points, T, K, 32, 48)
    np.testing.assert_array_equal(ours, jddad.project_pointcloud_to_depth(points, T, K, 32, 48))
    assert (ours > 0).sum() > 20


@pytest.mark.parametrize("cameras", [CAMS[:1], CAMS, CAMS[::-1]], ids=["one", "two", "swapped"])
@pytest.mark.parametrize("context", [(0, 0), (1, 1)])
def test_samples_match_the_jax_package(fresh_tree, cameras, context):
    root = fresh_tree("scene")
    kw = dict(cameras=cameras, depth_type="LIDAR", with_pose=True, back_context=context[0],
              forward_context=context[1])
    for transform in (_as_read, None, "test"):
        tf = jtf = transform
        if transform == "test":
            aug = jax_default_config().datasets.augmentation
            aug.image_shape = (16, 24)
            tf, jtf = make_transform("test", aug), jax_make_transform("test", aug)
        ours = ddad.DDADDataset(root, "train", data_transform=tf, **kw)
        theirs = jddad.DDADDataset(root, "train", data_transform=jtf, **kw)
        assert ours.index == theirs.index and len(ours) == 4 - sum(context)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert_samples_equal(a, b)
            lead = (len(cameras),) if len(cameras) > 1 else ()
            assert a["rgb"].shape == lead + ((32, 48, 3) if transform != "test" else (16, 24, 3))
            assert a["depth"].shape == lead + (32, 48, 1) and (a["depth"] > 0).any()


def test_depth_cache_reads_the_same_in_both_packages(fresh_tree):
    for writer, reader in ((ddad, jddad), (jddad, ddad)):
        root = fresh_tree(writer.__name__.split(".")[0])
        kw = dict(cameras=CAMS, depth_type="LIDAR")
        written = writer.DDADDataset(root, data_transform=_as_read, **kw)
        first = [written[i]["depth"] for i in range(len(written))]
        caches = sorted(glob.glob(os.path.join(root, "*", "point_cloud", "LIDAR", "*.npz")))
        names = [os.path.basename(p) for p in caches]
        assert names == sorted([f"{k:015d}.npz" for k in range(4)]
                               + [f"{k:015d}.depth_{c}.npz" for k in range(4) for c in CAMS])
        for p in caches:
            if ".depth_" in p:
                with np.load(p) as f:
                    assert f.files == ["depth"] and f["depth"].dtype == np.float32
        read = reader.DDADDataset(root, data_transform=_as_read, **kw)
        for i, depth in enumerate(first):
            np.testing.assert_array_equal(read[i]["depth"], depth)
        # the cache is what a fresh projection gives
        fresh = reader.DDADDataset(fresh_tree(f"fresh_{writer.__name__.split('.')[0]}"),
                                   data_transform=_as_read, **kw)
        for i, depth in enumerate(first):
            np.testing.assert_array_equal(fresh[i]["depth"], depth)


def test_stack_multicam_batch_matches_the_jax_package(ddad_root):
    ds = ddad.DDADDataset(ddad_root, cameras=CAMS, depth_type="LIDAR", back_context=1,
                          forward_context=1, with_pose=True)
    batch = next(iter(DataLoader(ds, batch_size=2, num_workers=1).epoch(0)))
    batch["jitter"] = np.random.default_rng(1).uniform(size=(2, 4)).astype(np.float32)
    ours, theirs = stack_multicam_batch(batch), jax_stack(batch)
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        if isinstance(v, list) and isinstance(v[0], np.ndarray):
            for x, y in zip(v, theirs[k]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(v, theirs[k])
    assert ours["rgb"].shape == (4, 32, 48, 3) and ours["intrinsics"].shape == (4, 3, 3)
    assert [c.shape for c in ours["pose_context"]] == [(4, 4, 4)] * 2
    np.testing.assert_array_equal(ours["jitter"], np.repeat(batch["jitter"], 2, axis=0))
    np.testing.assert_array_equal(ours["idx"], batch["idx"])
    single = {"rgb": batch["rgb"][:, 0], "jitter": batch["jitter"]}
    assert stack_multicam_batch(single) is single                 # nothing to fold


@pytest.mark.parametrize("device_jitter", [True, False], ids=["device-jitter", "host-jitter"])
def test_train_transform_runs_per_camera_from_one_draw(ddad_root, device_jitter):
    aug = config_from_dict({}).datasets.augmentation
    aug.image_shape, aug.device_jitter = (16, 24), device_jitter
    tf = make_transform("train", aug, seed=3)
    kw = dict(depth_type="LIDAR", back_context=1, forward_context=1,
              data_transform=_as_read)
    both = ddad.DDADDataset(ddad_root, cameras=CAMS, **kw)
    for idx, epoch in ((0, 0), (1, 2)):
        stacked = tf(both[idx], idx=idx, epoch=epoch)
        assert stacked["rgb"].shape == (2, 16, 24, 3)
        for c, cam in enumerate(CAMS):
            alone = tf(ddad.DDADDataset(ddad_root, cameras=[cam], **kw)[idx], idx=idx,
                       epoch=epoch)
            for key, v in alone.items():
                if key in ("idx", "filename"):
                    continue
                if key == "jitter":
                    np.testing.assert_array_equal(stacked[key], v)        # one row, shared
                elif isinstance(v, list):
                    for x, y in zip(stacked[key], v):
                        np.testing.assert_array_equal(x[c], y)
                else:
                    np.testing.assert_array_equal(stacked[key][c], v, err_msg=key)
        if device_jitter:
            assert stacked["jitter"].shape == (4,) and stacked["rgb"].dtype == np.uint8
            assert not np.array_equal(stacked["jitter"], [1, 1, 1, 0])
        else:
            assert "jitter" not in stacked and stacked["rgb_original"].shape == (2, 16, 24, 3)
    # the loader's batch folds to one row of factors per image, a sample's
    # cameras alike
    loader = DataLoader(both, batch_size=2, num_workers=2, transform=tf)
    folded = stack_multicam_batch(next(iter(loader.epoch(0))))
    assert folded["rgb"].shape == (4, 16, 24, 3)
    if device_jitter:
        assert folded["jitter"].shape == (4, 4)
        np.testing.assert_array_equal(folded["jitter"][0], folded["jitter"][1])
        np.testing.assert_array_equal(folded["jitter"][2], folded["jitter"][3])


def test_jax_folds_a_stack_of_jitter_rows_the_port_does_not(ddad_root):
    """(k): the JAX reader transforms each camera, stacking one row of jitter
    factors a camera ([N, 4]); its fold repeats that stack along the batch
    axis, [B*N, N, 4], which the device jitter cannot take. The port's
    folded batch has [B*N, 4]."""
    aug = jax_default_config().datasets.augmentation
    aug.image_shape = (16, 24)
    kw = dict(cameras=CAMS, depth_type="LIDAR", back_context=1, forward_context=1)
    theirs = jddad.DDADDataset(ddad_root, data_transform=jax_make_transform("train", aug), **kw)
    jax_batch = jax_stack(next(iter(JaxLoader(theirs, batch_size=2, num_workers=1).epoch(0))))
    assert jax_batch["jitter"].shape == (4, 2, 4)
    ours = ddad.DDADDataset(ddad_root, data_transform=_as_read, **kw)
    loader = DataLoader(ours, batch_size=2, num_workers=1,
                        transform=make_transform("train", aug))
    assert stack_multicam_batch(next(iter(loader.epoch(0))))["jitter"].shape == (4, 4)


def test_camera_names_are_matched_as_given(ddad_root):
    """The configs name 'camera_01' and a 'lidar' depth; the fixture's
    channels are 'CAMERA_01' and 'LIDAR'. Neither package folds case."""
    for package in (ddad, jddad):
        ds = package.DDADDataset(ddad_root, cameras=["camera_01"], depth_type="LIDAR")
        with pytest.raises(KeyError, match="camera_01"):
            ds[0]
        ds = package.DDADDataset(ddad_root, cameras=["CAMERA_01"], depth_type="lidar",
                                 data_transform=_as_read)
        assert not ds[0]["depth"].any()                 # no datum: an all-zero depth


def _dgp_config(root, cameras):
    cfg = config_from_dict({
        "model": {"name": "SelfSupModel", "depth_net": {"name": "DepthResNet", "version": "18"},
                  "pose_net": {"name": "PoseNet"}, "params": {"crop": "", "max_depth": 200.0}},
        "arch": {"max_epochs": 1},
        "datasets": {"augmentation": {"image_shape": (32, 64)}}})
    for mode in ("train", "validation", "test"):
        d = cfg.datasets[mode]
        d.dataset, d.path, d.split, d.depth_type = ["DGP"], [root], ["train"], ["LIDAR"]
        d.cameras, d.batch_size, d.num_workers = [cameras], 2, 1
    return parse_train_config(cfg)


def test_two_camera_epoch_through_the_port_trainer(fresh_tree):
    """Two samples of two cameras a step: the train step and the eval step
    take folded batches of 4 images; validate averages a sample's cameras."""
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES
    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    root = fresh_tree("trainer")
    cfg = _dgp_config(root, CAMS)
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    steps = []
    build = trainer._train_step_for

    def watched(num_scales):
        step = build(num_scales)

        def run(acc, batch, progress):
            steps.append({k: np.shape(v) for k, v in batch.items() if k in ("rgb", "jitter")})
            return step(acc, batch, progress)
        return run
    trainer._train_step_for = watched
    out = trainer.train_epoch(0)
    assert steps == [{"rgb": (4, 32, 64, 3), "jitter": (4, 4)}]
    assert np.isfinite(out["loss"]) and trainer.step == 1
    (table,) = trainer.validate(0)
    # a sample's row is its cameras' mean: the table is the mean of the two
    # one-camera tables of the same weights
    alone = []
    for cam in CAMS:
        other = Trainer(_dgp_config(root, [cam]), device="cpu")
        other.model.load_state_dict(trainer.model.state_dict())
        alone.append(other.validate(0)[0])
    for m in EVAL_MODES:
        assert np.all(np.isfinite(table[m]))
        np.testing.assert_allclose(table[m], (alone[0][m] + alone[1][m]) / 2, rtol=1e-5,
                                   atol=1e-6, err_msg=m)
    # the same config through setup_dataset builds the reader with the cameras
    (ds,) = setup_dataset(cfg.datasets.validation, "validation", cfg.datasets.augmentation)
    assert isinstance(ds, ddad.DDADDataset) and ds.cameras == CAMS and len(ds) == 4
    assert ds.index == [(0, k) for k in range(4)]


def test_input_depth_is_the_named_lidar_projected(ddad_root):
    """ROADMAP.md §3 (p): the JAX package's DGP reader takes
    ``input_depth_type`` and drops it (no 'input_depth' in its samples, and
    ``setup_dataset`` never passes it); the port projects the named lidar
    into each camera as it projects the ground truth's, through the same
    cache, and ``setup_dataset`` passes the config's."""
    kw = dict(cameras=CAMS, depth_type="LIDAR", input_depth_type="LIDAR")
    theirs = jddad.DDADDataset(ddad_root, data_transform=_as_read, **kw)
    assert "input_depth" not in theirs[0]
    ours = ddad.DDADDataset(ddad_root, data_transform=_as_read, **kw)
    for i in range(len(ours)):
        sample = ours[i]
        assert sample["input_depth"].shape == sample["depth"].shape
        np.testing.assert_array_equal(sample["input_depth"], sample["depth"])
        np.testing.assert_array_equal(sample["depth"], theirs[i]["depth"])
    cfg = config_from_dict({"datasets": {"test": {
        "dataset": ["DGP"], "path": [ddad_root], "split": ["val"], "depth_type": ["LIDAR"],
        "input_depth_type": ["LIDAR"], "cameras": [CAMS]}}})
    (ds,) = setup_dataset(cfg.datasets.test, "test", cfg.datasets.augmentation)
    assert "input_depth" in ds[0]
