"""The port's KITTI and image-folder readers (``datasets/{kitti,kitti_utils,
image_folder}.py``) and their loader against the JAX package's, on the JAX
tests' fixture trees (tests/test_datasets.py: a KITTI raw drive of 6 frames
with calib, OXTS and velodyne depth; three drives of mixed native sizes),
and a folder of numbered frames (PNG and JPEG). Everything is compared bit
for bit: images (uint8 as read, float32 after the eval transform), depths,
intrinsics, poses, context frames, sample lists, ``sample_shape`` and the
eval loader's shape buckets.

One rule differs on purpose (``ROADMAP.md`` §3 (j)): under a split file the
image-folder reader takes a frame's own neighbour in its folder as its
context, where the JAX package takes a file at a list position.

The slice as a whole: ``cli.train``'s ``build_trainer`` on the KITTI tree
(context 1/1, 32x64 train shape, DepthResNet-18 + PoseNet, batch 2, no flip
and no jitter, as tests/test_torch_trainer.py holds the Synthetic loop)
against JAX's ``Trainer`` from the same initial variables: one epoch of 2
steps, then the validation table at the native 48x64 ground truth.
Tolerances, and what was measured on a CPU: the epoch's loss rtol 1e-5
(measured 5e-7); the update's cosine >= 0.9995 (measured 0.99988; on
Synthetic's smooth textures tests/test_torch_trainer.py measures 0.99998 and
holds 0.9999: Adam's first steps are about lr * sign(g), and the fixture's
uniform-noise frames give more gradients near 0, whose sign the two
packages' orders of summation can flip) and relative error <= 2e-2
(measured 1.5e-2); the table rtol 1e-3, atol 1e-4, a1-a3 within 2 /
n_valid, as tests/test_torch_trainer.py.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec
from PIL import Image

from packnet_sfm_tpu.core.config import get_default_config as jax_default_config
from packnet_sfm_tpu.core.config import parse_train_config as jax_parse_train_config
from packnet_sfm_tpu.datasets import kitti_utils as jku
from packnet_sfm_tpu.datasets.image_folder import ImageFolderDataset as JaxImageFolder
from packnet_sfm_tpu.datasets.kitti import KITTIDataset as JaxKITTI
from packnet_sfm_tpu.datasets.kitti import read_png_depth as jax_read_png_depth
from packnet_sfm_tpu.datasets.loader import DataLoader as JaxLoader
from packnet_sfm_tpu.datasets.loader import make_transform as jax_make_transform
from packnet_sfm_tpu.engine import train as jax_train
from packnet_sfm_tpu.engine.train import zero_metrics as jax_zero_metrics
from packnet_sfm_tpu.engine.trainer import Trainer as JaxTrainer
from packnet_sfm_tpu.parallel.mesh import make_mesh
from packnet_sfm_tpu_torch.core.config import ConfigNode, parse_train_config
from packnet_sfm_tpu_torch.datasets import kitti_utils as tku
from packnet_sfm_tpu_torch.datasets.image_folder import ImageFolderDataset, dummy_intrinsics
from packnet_sfm_tpu_torch.datasets.kitti import KITTIDataset, read_png_depth
from packnet_sfm_tpu_torch.datasets.loader import DataLoader, make_transform
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES
from packnet_sfm_tpu_torch.utils.convert import from_jax
from tests.test_datasets import _mixed_size_tree, kitti_root  # noqa: F401 (a fixture)
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

torch.set_num_threads(1)


def _as_read(sample, idx=0):
    return sample


def assert_samples_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key, a in ours.items():
        b = theirs[key]
        if isinstance(a, list):
            assert len(a) == len(b), key
            for x, y in zip(a, b):
                assert np.asarray(x).dtype == np.asarray(y).dtype, key
                np.testing.assert_array_equal(x, y, err_msg=key)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


def _eval_aug(shape=(32, 48)):
    aug = jax_default_config().datasets.augmentation
    aug.image_shape = shape
    return aug


# --- kitti_utils ----------------------------------------------------------------

def test_kitti_utils_match_the_jax_package(kitti_root):
    root, _ = kitti_root
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt", "calib_imu_to_velo.txt"):
        ours = tku.read_calib_file(str(root / "2011_09_26" / name))
        theirs = jku.read_calib_file(str(root / "2011_09_26" / name))
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
    rng = np.random.default_rng(0)
    for _ in range(5):
        rpy = rng.uniform(-np.pi, np.pi, size=3)
        np.testing.assert_array_equal(tku.rotation_from_rpy(*rpy), jku.rotation_from_rpy(*rpy))
        packet = np.concatenate([[49.0, 8.4, 110.0], rpy, np.zeros(24)])
        for a, b in zip(tku.pose_from_oxts_packet(packet, 0.65),
                        jku.pose_from_oxts_packet(packet, 0.65)):
            np.testing.assert_array_equal(a, b)
        T = tku.transform_from_rot_trans(tku.rotation_from_rpy(*rpy), rng.normal(size=3))
        np.testing.assert_array_equal(
            T, jku.transform_from_rot_trans(jku.rotation_from_rpy(*rpy), T[:3, 3]))
        np.testing.assert_array_equal(tku.invert_pose_numpy(T), jku.invert_pose_numpy(T))


# --- the KITTI reader ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(depth_type="velodyne"),
    dict(depth_type="velodyne", back_context=1, forward_context=1, with_pose=True),
    dict(depth_type="velodyne", input_depth_type="velodyne", back_context=1,
         forward_context=1, strides=(1, 2)),
    dict(depth_type="groundtruth", back_context=2, forward_context=0),
    dict(back_context=0, forward_context=2, with_pose=True),
], ids=["depth", "context-pose", "strides-input-depth", "missing-depth-files", "forward-only"])
def test_kitti_samples_match_the_jax_package(kitti_root, kw):
    root, split = kitti_root
    for transform in (_as_read, None, "test"):
        tf = jtf = transform
        if transform == "test":
            tf = make_transform("test", _eval_aug())
            jtf = jax_make_transform("test", _eval_aug())
        ours = KITTIDataset(str(root), str(split), data_transform=tf, **kw)
        theirs = JaxKITTI(str(root), str(split), data_transform=jtf, **kw)
        assert ours.paths == theirs.paths
        assert ours.backward_context_idxs == theirs.backward_context_idxs
        assert ours.forward_context_idxs == theirs.forward_context_idxs
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert_samples_equal(a, b)
            assert ours.sample_shape(i) == theirs.sample_shape(i) == (48, 64)
        if transform is _as_read and len(ours):
            assert ours[0]["rgb"].dtype == np.uint8
    if kw.get("depth_type") == "groundtruth":
        assert len(ours) == 0                     # the filter drops frames with no depth file


def test_png_depth_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    raw = (rng.uniform(0, 80 * 256, size=(12, 20)) * (rng.uniform(size=(12, 20)) < 0.4))
    path = str(tmp_path / "d.png")
    Image.fromarray(raw.astype(np.uint16)).save(path)
    ours, theirs = read_png_depth(path), jax_read_png_depth(path)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert (ours == -1).any() and ours.max() > 1
    Image.fromarray(np.full((4, 4), 200, np.uint8)).save(tmp_path / "byte.png")
    with pytest.raises(ValueError, match="16-bit"):
        read_png_depth(str(tmp_path / "byte.png"))


def test_eval_buckets_on_mixed_sizes_match_the_jax_package(tmp_path_factory):
    root, split, sizes = _mixed_size_tree(tmp_path_factory)
    ours = KITTIDataset(str(root), str(split), train=False, depth_type="velodyne",
                        data_transform=make_transform("test", _eval_aug()))
    theirs = JaxKITTI(str(root), str(split), train=False, depth_type="velodyne",
                      data_transform=jax_make_transform("test", _eval_aug()))
    assert [ours.sample_shape(i) for i in range(9)] == [
        theirs.sample_shape(i) for i in range(9)] == [s for s in sizes for _ in range(3)]
    kw = dict(batch_size=2, shuffle=False, drop_last=False, num_workers=2,
              process_index=0, process_count=1)
    got, want = list(DataLoader(ours, **kw).epoch(0)), list(JaxLoader(theirs, **kw).epoch(0))
    assert len(got) == len(want) == 6                    # ceil(3 / 2) in each of 3 buckets
    shapes = set()
    for a, b in zip(got, want):
        assert a.get("pad_count", 0) == b.get("pad_count", 0)
        for key in ("rgb", "depth", "intrinsics", "idx"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["rgb"].shape[1:3] == (32, 48)
        shapes.add(a["depth"].shape[1:3])
    assert shapes == set(sizes)


# --- the image-folder reader -------------------------------------------------------

@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A folder of 7 numbered frames, 40x56, alternately PNG and JPEG."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(4)
    for i in range(7):
        arr = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / f"{i:06d}.{'png' if i % 2 else 'jpg'}", quality=95)
    return root


@pytest.mark.parametrize("context", [(0, 0), (1, 1), (2, 1), (0, 2)])
def test_image_folder_matches_the_jax_package_on_a_folder_of_frames(frames, context):
    back, fwd = context
    for transform in (_as_read, None, "test"):
        tf = jtf = transform
        if transform == "test":
            tf = make_transform("test", _eval_aug((24, 32)))
            jtf = jax_make_transform("test", _eval_aug((24, 32)))
        ours = ImageFolderDataset(str(frames), data_transform=tf, back_context=back,
                                  forward_context=fwd)
        theirs = JaxImageFolder(str(frames), data_transform=jtf, back_context=back,
                                forward_context=fwd)
        assert ours.files == theirs.files and len(ours) == 7 - back - fwd
        for i in range(len(ours)):
            assert_samples_equal(ours[i], theirs[i])
    rgb = np.zeros((40, 56, 3), np.uint8)
    np.testing.assert_array_equal(dummy_intrinsics(rgb), ours[0]["intrinsics"]
                                  if transform is None else dummy_intrinsics(rgb))


def test_image_folder_context_under_a_split_is_the_frames_own_neighbour(frames, tmp_path):
    """A split listing frames 2-5 with back_context 1 keeps frames 3-5; the
    context of frame 3 is frame 2 in the port, frame 0 in the JAX package
    (the sample's list position in the folder's listing)."""
    split = tmp_path / "split.txt"
    names = sorted(os.listdir(frames))
    split.write_text("".join(f"{n}\n" for n in names[2:6]))
    ours = ImageFolderDataset(str(frames), split=str(split), data_transform=_as_read,
                              back_context=1)
    theirs = JaxImageFolder(str(frames), split=str(split), data_transform=_as_read,
                            back_context=1)
    assert ours.files == theirs.files == [str(frames / n) for n in names[3:6]]
    assert ours._neighbor(0, -1) == str(frames / names[2])
    assert theirs._neighbor(0, -1) == str(frames / names[0])
    np.testing.assert_array_equal(ours[0]["rgb_context"][0],
                                  np.asarray(Image.open(frames / names[2]).convert("RGB")))
    # where a frame has no neighbour in its folder, the port refuses
    split.write_text(f"{names[1]}\n{names[0]}\n")
    with pytest.raises(IndexError, match="no image"):
        ImageFolderDataset(str(frames), split=str(split), back_context=1)[0]


# --- the slice as a whole: the KITTI tree through both trainers ---------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, copy=True), tree)


def _kitti_config(root, split):
    c = jax_default_config()
    c.arch.max_epochs = 1
    c.model.name = "SelfSupModel"
    c.model.depth_net.name = "DepthResNet"
    c.model.depth_net.version = "18"
    c.model.pose_net.name = "PoseNet"
    c.model.loss.flip_lr_prob = 0.0
    c.datasets.augmentation.jittering = ()
    c.datasets.augmentation.image_shape = (32, 64)
    for mode in ("train", "validation", "test"):
        d = c.datasets[mode]
        d.dataset, d.path, d.split, d.depth_type = ["KITTI"], [str(root)], [str(split)], [
            "velodyne"]
        d.batch_size, d.num_workers = 2, 1
    c.datasets.train.back_context = c.datasets.train.forward_context = 1
    return jax_parse_train_config(c)

def _committed(tree, mesh):
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _epoch_committed(jt, mesh):
    """JAX's ``train_epoch(0)`` with its metrics committed to the mesh."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_train, "zero_metrics", lambda: _committed(jax_zero_metrics(), mesh))
        return jt.train_epoch(0)


@pytest.fixture(scope="module")
def kitti_epoch(kitti_root):
    from packnet_sfm_tpu_torch.cli.train import build_trainer

    root, split = kitti_root
    jcfg = _kitti_config(root, split)
    mesh = make_mesh(num_devices=1)
    jt = JaxTrainer(jcfg, mesh=mesh)
    jt.init_state(next(iter(jt.train_loaders[0].epoch(0))))
    # JAX's step returns its state and metrics committed to the mesh; from
    # uncommitted ones it would compile a second program (the same numbers)
    jt.state = _committed(jt.state, mesh)
    state0 = from_jax(_np_tree(jt.state.params), _np_tree(jt.state.batch_stats))
    pt = build_trainer(copy.deepcopy(jcfg.to_dict()), device="cpu")
    pt.model.load_state_dict(state0)
    return dict(state0=state0, j_train=_epoch_committed(jt, mesh), t_train=pt.train_epoch(0),
                j_val=jt.validate(0), t_val=pt.validate(0),
                j_state=from_jax(_np_tree(jt.state.params), _np_tree(jt.state.batch_stats)),
                t_state={k: v.numpy() for k, v in pt.model.state_dict().items()}, trainer=pt)


def test_kitti_tree_trains_as_the_jax_trainer(kitti_epoch):
    got, want = kitti_epoch["t_train"], kitti_epoch["j_train"]
    trainer = kitti_epoch["trainer"]
    assert trainer.steps_per_epoch == 2 and trainer.step == 2     # 4 samples with context
    for key in ("loss", "photometric_loss", "smoothness_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    keys = sorted(k for k in kitti_epoch["state0"] if "running_" not in k)

    def flat(state):
        return np.concatenate([np.asarray(state[k], np.float64).ravel() for k in keys])
    p0 = flat(kitti_epoch["state0"])
    dj, dt = flat(kitti_epoch["j_state"]) - p0, flat(kitti_epoch["t_state"]) - p0
    assert np.linalg.norm(dt) > 0
    assert dj @ dt / np.linalg.norm(dj) / np.linalg.norm(dt) >= 0.9995
    assert np.linalg.norm(dt - dj) / np.linalg.norm(dj) <= 2e-2


def test_kitti_tree_validates_as_the_jax_trainer(kitti_epoch):
    (want,), (got,) = kitti_epoch["j_val"], kitti_epoch["t_val"]
    ds = kitti_epoch["trainer"].val_datasets[0]
    assert isinstance(ds, KITTIDataset) and len(ds) == 6
    gt = np.stack([ds[i]["depth"] for i in range(len(ds))])
    assert gt.shape[1:3] == (48, 64)                     # native resolution
    valid = (gt[..., 0] > 0) & (gt[..., 0] < 80)
    n_valid = int(valid.reshape(len(gt), -1).sum(axis=1).min())
    for mode in EVAL_MODES:
        np.testing.assert_allclose(got[mode][:4], want[mode][:4], rtol=1e-3, atol=1e-4,
                                   err_msg=mode)
        np.testing.assert_allclose(got[mode][4:], want[mode][4:], rtol=0, atol=2.0 / n_valid)


def test_setup_dataset_reads_the_kitti_config_as_the_jax_package(kitti_root):
    """The train split of the same config: the same samples as JAX's reader,
    before the train transform (which the port's loader applies)."""
    from packnet_sfm_tpu.datasets.loader import setup_dataset as jax_setup
    from packnet_sfm_tpu_torch.datasets.loader import setup_dataset

    root, split = kitti_root
    jcfg = _kitti_config(root, os.path.basename(str(split)))     # relative to the path
    cfg = parse_train_config(ConfigNode.from_dict(copy.deepcopy(jcfg.to_dict())))
    aug = cfg.datasets.augmentation
    for req in ({}, {"gt_pose": True}):
        (ours,) = setup_dataset(cfg.datasets.train, "train", aug, 42, req)
        (theirs,) = jax_setup(jcfg.datasets.train, "train", jcfg.datasets.augmentation, 42, req)
        assert ours.paths == theirs.paths and ours.with_pose == bool(req)
        theirs.data_transform = _as_read
        for i in range(len(ours)):
            assert_samples_equal(ours[i], theirs[i])
