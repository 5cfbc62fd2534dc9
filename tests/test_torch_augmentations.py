"""The port's train transform (``datasets/augmentations.train_transform``)
against the JAX package's, and its draw of the jitter factors in the train
split (``datasets/loader``).

- Given the same ``np.random.Generator``, ``train_transform`` returns JAX's
  sample bit for bit: the device-jitter path (images as they come, factors
  in 'jitter') and the host path (float32, originals duplicated, jitter
  applied with the hue shift through cv2), with and without a crop and the
  'area' and 'lanczos' resizes, from uint8 and from float32 images.
- The jitter draw of a train split (the train loader's transform) is a
  pure function of (seed, epoch, position in the repeated split): it
  differs between epochs and between the repeat copies of a sample, and is
  the same when read again. The JAX
  package seeds it from (seed, sample index) alone, so that all of these
  are equal there; the port does not copy that.
"""

import numpy as np
import pytest

from packnet_sfm_tpu.datasets import augmentations as jaug
from packnet_sfm_tpu.datasets.loader import make_transform as jax_make_transform
from packnet_sfm_tpu_torch.core.config import config_from_dict, parse_train_config
from packnet_sfm_tpu_torch.datasets import augmentations as taug
from packnet_sfm_tpu_torch.datasets.loader import (
    RepeatDataset,
    make_transform,
    setup_dataloader,
    setup_dataset,
)
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset

JITTER = (0.2, 0.2, 0.2, 0.05)


def _sample(dtype):
    rng = np.random.default_rng(5)
    s = SyntheticSfmDataset(length=1, height=40, width=56, seed=2)[0]
    s["input_depth"] = s["depth"] * (rng.uniform(size=s["depth"].shape) < 0.5)
    if dtype == np.uint8:
        s["rgb"] = (s["rgb"] * 255).astype(np.uint8)
        s["rgb_context"] = [(c * 255).astype(np.uint8) for c in s["rgb_context"]]
    return s


def _copy(sample):
    return {k: [np.copy(c) for c in v] if isinstance(v, list) else np.copy(v)
            for k, v in sample.items()}


@pytest.mark.parametrize("device_jitter", [True, False], ids=["device-jitter", "host-jitter"])
@pytest.mark.parametrize("crop,shape,resize_filter", [
    ((), (), "area"), ((), (24, 32), "area"), ((0.1, 4, -2, 0.9), (20, 28), "area"),
    ((36, 30), (24, 40), "lanczos"), ((), (64, 80), "area")],
    ids=["none", "area", "crop-area", "crop-lanczos", "upscale"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_train_transform_matches_the_jax_package(device_jitter, crop, shape, resize_filter,
                                                 dtype):
    sample = _sample(dtype)
    for jitter in (JITTER, (0.3, 0.1, 0.4, 0.0), ()):
        ours = taug.train_transform(_copy(sample), shape, jitter, crop, np.random.default_rng(9),
                                    device_jitter=device_jitter, resize_filter=resize_filter)
        theirs = jaug.train_transform(_copy(sample), shape, jitter, crop,
                                      np.random.default_rng(9), device_jitter=device_jitter,
                                      resize_filter=resize_filter)
        assert ours.keys() == theirs.keys()
        assert ("jitter" in ours) == (device_jitter and bool(jitter))
        for key, value in theirs.items():
            got = ours[key]
            if isinstance(value, list):
                assert len(got) == len(value)
                for a, b in zip(got, value):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                    assert a.dtype == b.dtype
            elif isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got, value, err_msg=key)
                assert got.dtype == value.dtype, key
            else:
                assert got == value, key
        if not device_jitter:
            assert ours["rgb"].dtype == np.float32 and "rgb_original" in ours


def test_area_resize_matches_the_jax_package():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(45, 70, 3), dtype=np.uint8)
    f32 = rng.uniform(size=(45, 70, 3)).astype(np.float32)
    for image in (u8, f32):
        for shape in ((20, 33), (45, 70), (90, 100)):
            ours = taug.resize_image(image, shape, "area")
            theirs = jaug.resize_image(image, shape, "area")
            np.testing.assert_array_equal(ours, theirs)
            assert ours.dtype == theirs.dtype


def _train_loader(repeat, seed=4):
    """The train loader of a 3-sample Synthetic split repeated ``repeat``
    times, and ``load(i, epoch)``: what it makes of position i in an
    epoch."""
    cfg = parse_train_config(config_from_dict({"datasets": {"train": {
        "dataset": ["Synthetic"], "path": [""], "split": [""], "depth_type": [""],
        "synthetic_length": 3, "synthetic_height": 16, "synthetic_width": 24,
        "repeat": [repeat], "batch_size": 2, "num_workers": 2}}}))
    aug = cfg.datasets.augmentation
    assert tuple(aug.jittering) == JITTER and aug.device_jitter
    (loader,) = setup_dataloader(setup_dataset(cfg.datasets.train, "train", aug, seed),
                                 cfg.datasets.train, "train", seed, aug)

    def load(i, epoch):
        return loader.transform(loader.dataset[i], i, epoch)
    return loader, load


def test_jitter_draw_is_fresh_per_epoch_and_repeat_copy():
    loader, load = _train_loader(repeat=2)
    assert isinstance(loader.dataset, RepeatDataset) and len(loader.dataset) == 6
    draws = {(e, i): load(i, e)["jitter"] for e in range(2) for i in range(6)}
    # a repeat copy of a sample (i and i + 3) is the same image with other factors
    np.testing.assert_array_equal(load(4, 0)["rgb"], load(1, 0)["rgb"])
    assert load(4, 0)["idx"] == 1
    rows = np.stack(list(draws.values()))
    assert len({tuple(r) for r in rows}) == len(rows)        # every draw differs
    # a pure function of (seed, epoch, position): read again, the same
    for (e, i), value in draws.items():
        np.testing.assert_array_equal(load(i, e)["jitter"], value)
    # and of the seed
    _, other = _train_loader(repeat=2, seed=5)
    assert not np.array_equal(other(0, 0)["jitter"], draws[(0, 0)])


def test_jitter_draw_is_what_the_loader_batches_carry():
    loader, load = _train_loader(repeat=2)
    assert "jitter" not in loader.dataset[0]              # the loader's transform draws it
    for epoch in (0, 1):
        for batch in loader.epoch(epoch):
            for row, idx in zip(batch["jitter"], batch["idx"]):
                positions = [i for i in range(6) if i % 3 == idx]
                assert any(np.array_equal(row, load(i, epoch)["jitter"])
                           for i in positions)
    first = np.concatenate([b["jitter"] for b in loader.epoch(0)])
    again = np.concatenate([b["jitter"] for b in loader.epoch(0)])
    second = np.concatenate([b["jitter"] for b in loader.epoch(1)])
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(np.sort(first, axis=0), np.sort(second, axis=0))


def test_the_jax_draw_repeats_across_epochs_and_copies():
    """What the port does not copy: JAX's train transform draws from (seed,
    sample index), the same factors for every epoch and repeat copy."""
    cfg = config_from_dict({})
    tf = jax_make_transform("train", cfg.datasets.augmentation, seed=4)
    sample = SyntheticSfmDataset(length=1, height=16, width=24, seed=4)[0]
    a = tf(_copy(sample), idx=0)["jitter"]
    b = tf(_copy(sample), idx=0)["jitter"]
    np.testing.assert_array_equal(a, b)
    ours = make_transform("train", cfg.datasets.augmentation, seed=4)
    assert not np.array_equal(ours(_copy(sample), idx=0, epoch=0)["jitter"],
                              ours(_copy(sample), idx=0, epoch=1)["jitter"])
