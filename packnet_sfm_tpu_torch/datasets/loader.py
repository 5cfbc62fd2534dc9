"""Deterministic host-sharded data loader: the port's own copy of
``packnet_sfm_tpu/datasets/loader.py`` (numpy; the same batches in the same
order for the same dataset, seed and epoch).

Each process loads only its shard (indices[process_index::process_count],
``setup_dataloader`` taking both from the process group), worker threads prefetch decode and transform, and shuffling is seeded by
(seed, epoch). Eval loaders keep every sample: the last batch is padded by
wrapping and 'pad_count' marks the pad rows. Batches are stacked numpy; the
eval step moves them to the device.

The train split's transform is the loader's: it is called with the
sample's position in the (repeated) split and the epoch, and draws its
generator from (seed, epoch, position), so every epoch and every repeat
copy of a sample sees fresh jitter factors, each a pure function of those
three. (The JAX package seeds it
from (seed, sample index) alone, so that its every epoch and repeat copy of
a sample draws the same factors.) A stacked multi-camera sample (DGP) is
transformed camera by camera, each camera from the same draw, so that the
cameras of a sample share their jitter factors, as in the JAX package,
where every camera's transform is seeded alike.

Datasets: KITTI (raw tree and split file), Image (a folder of frames), DGP
(DDAD scenes) and Synthetic.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

_STACK_KEYS = ("rgb", "rgb_original", "depth", "input_depth", "intrinsics",
               "pose", "jitter")
_LIST_KEYS = ("rgb_context", "rgb_context_original", "pose_context", "depth_context")


def collate(samples: Sequence[dict]) -> dict:
    """Stack a list of sample dicts into a batch dict (NHWC numpy)."""
    batch: dict = {}
    first = samples[0]
    for key in _STACK_KEYS:
        if key in first:
            batch[key] = np.stack([s[key] for s in samples])
    for key in _LIST_KEYS:
        if key in first:
            n_ctx = len(first[key])
            batch[key] = [np.stack([s[key][i] for s in samples])
                          for i in range(n_ctx)]
    if "idx" in first:
        batch["idx"] = np.asarray([s["idx"] for s in samples])
    if "filename" in first:
        batch["filename"] = [s["filename"] for s in samples]
    return batch


def _as_loaded(sample, idx, epoch):
    return sample


class DataLoader:
    """Deterministic, host-sharded, thread-prefetching loader. Each sample
    is ``transform(dataset[idx], idx, epoch)``; the default returns it as
    the dataset gives it."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 42,
                 drop_last: bool = True, num_workers: int = 8, process_index: int = 0,
                 process_count: int = 1, transform=_as_loaded):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        return len(self._batch_plan(0))

    def _shard(self, order: np.ndarray) -> np.ndarray:
        """This process's stride-shard of ``order``, padded first by wrapping
        to a multiple of process_count, so that every process gets the same
        number of batches; each wrapped duplicate lands on another process."""
        n = len(order)
        if self.process_count > 1 and n % self.process_count:
            total = -(-n // self.process_count) * self.process_count
            order = np.concatenate([order, order[: total - n]])
        return order[self.process_index::self.process_count]

    def _batch_plan(self, epoch: int) -> list:
        """List of (idxs [batch_size], pad_count) for this process.

        Eval loaders on datasets exposing ``sample_shape(idx)`` are bucketed
        by shape, so that batches stay homogeneous.
        """
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).permutation(n)
        sample_shape = getattr(self.dataset, "sample_shape", None)
        if sample_shape is not None and not self.drop_last:
            groups: dict = {}
            for i in order:
                groups.setdefault(tuple(sample_shape(int(i))), []).append(i)
            # deterministic bucket order shared by all processes
            buckets = [np.asarray(groups[k]) for k in sorted(groups)]
        else:
            buckets = [order]
        plan = []
        for bucket in buckets:
            shard = self._shard(bucket)
            nb = len(shard) // self.batch_size if self.drop_last \
                else -(-len(shard) // self.batch_size)
            for bi in range(nb):
                idxs = shard[bi * self.batch_size:(bi + 1) * self.batch_size]
                pad = self.batch_size - len(idxs)
                if pad:
                    # pad by wrapping (np.resize wraps cyclically, so shards
                    # smaller than one batch still fill up)
                    idxs = np.concatenate([idxs, np.resize(shard, pad)])
                plan.append((idxs, pad))
        return plan

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Iterate batches for ``epoch`` (the order is a function of (seed,
        epoch)). Worker threads load one sample each; batches are assembled
        in plan order."""
        plan = self._batch_plan(epoch)
        nb = len(plan)

        def fetch(idx: int) -> dict:
            return self.transform(self.dataset[idx], idx, epoch)

        def assemble(samples, pad: int) -> dict:
            batch = collate(samples)
            if pad:
                batch["pad_count"] = pad
            return batch

        if self.num_workers <= 1:
            for idxs, pad in plan:
                yield assemble([fetch(int(i)) for i in idxs], pad)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # enough batches in flight to keep every worker busy
            depth = min(nb, max(2, -(-2 * self.num_workers // self.batch_size)))

            def submit(bi: int):
                idxs, pad = plan[bi]
                return [pool.submit(fetch, int(i))
                        for i in idxs], pad
            inflight = {bi: submit(bi) for bi in range(depth)}
            next_submit = depth
            for bi in range(nb):
                futures, pad = inflight.pop(bi)
                samples = [f.result() for f in futures]
                if next_submit < nb:
                    inflight[next_submit] = submit(next_submit)
                    next_submit += 1
                yield assemble(samples, pad)


def make_transform(mode: str, aug_cfg, seed: int = 42):
    """The per-sample transform of a split. The train transform is the
    train loader's, ``tf(sample, idx=0, epoch=0)``: its generator is drawn
    from (seed, epoch, idx), idx the sample's position in the (repeated)
    split. The eval transforms are the datasets' own."""
    from packnet_sfm_tpu_torch.datasets.augmentations import eval_transform, train_transform

    image_shape = tuple(aug_cfg.get("image_shape", ()) or ())
    if mode == "train":
        jitter = tuple(aug_cfg.get("jittering", ()) or ())
        crop = tuple(aug_cfg.get("crop_train_borders", ()) or ())
        device_jitter = bool(aug_cfg.get("device_jitter", True))
        resize_filter = str(aug_cfg.get("resize_filter", "area"))

        def one_camera(sample, idx, epoch):
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, idx]))
            return train_transform(sample, image_shape, jitter, crop, rng,
                                   device_jitter=device_jitter, resize_filter=resize_filter)

        def train_tf(sample, idx=0, epoch=0):
            if sample["rgb"].ndim == 3:
                return one_camera(sample, idx, epoch)
            return _per_camera(one_camera, sample, idx, epoch)
        return train_tf
    crop = tuple(aug_cfg.get("crop_eval_borders", ()) or ())

    def tf(sample, idx=0):
        return eval_transform(sample, image_shape, crop,
                              depth_preserve_input=(mode == "validation"))
    return tf


def _per_camera(transform, sample, idx, epoch):
    """``transform`` applied to each camera of a stacked sample [N, ...],
    restacked. The cameras' 'jitter' factors, drawn alike, become the one
    row [4] of the sample, which ``stack_multicam_batch`` repeats for each
    camera of the folded batch."""
    from packnet_sfm_tpu_torch.datasets.ddad import stack_cameras, unstack_cameras

    cams = [transform(cam, idx, epoch) for cam in unstack_cameras(sample)]
    jitter = [cam.pop("jitter") for cam in cams if "jitter" in cam]
    out = stack_cameras(cams)
    if jitter:
        out["jitter"] = jitter[0]
    return out


def _untransformed(sample, idx=0):
    """A train split's dataset transform: none, so that its reader hands the
    loader's train transform the decoded uint8 images."""
    return sample


class RepeatDataset:
    """Repeat a dataset N times per epoch."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self._offsets[di])]


def setup_dataset(cfg, mode: str, aug_cfg, seed: int = 42, requirements=None):
    """Instantiate the datasets named in a split config, one per entry. A
    train split's dataset repeats ``repeat[i]`` times an epoch and carries
    no transform (its loader applies the train transform); an eval split's
    carries the split's eval transform. ``requirements`` are the model's
    train-data needs ('gt_depth', 'input_depth', 'gt_pose'): the first two
    must be configured for a train split that is not Synthetic, the last
    loads KITTI's OXTS poses."""
    from packnet_sfm_tpu_torch.datasets.ddad import DDADDataset
    from packnet_sfm_tpu_torch.datasets.image_folder import ImageFolderDataset
    from packnet_sfm_tpu_torch.datasets.kitti import KITTIDataset
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset

    requirements = requirements or {}
    train = mode == "train"
    datasets = []
    for i, name in enumerate(cfg.dataset):
        if train and name != "Synthetic":
            if requirements.get("gt_depth") and not cfg.depth_type[i]:
                raise ValueError(
                    f"Model requires gt depth but train dataset {i} ({name}) "
                    "has no depth_type configured")
            if requirements.get("input_depth") and not (
                    i < len(cfg.input_depth_type) and cfg.input_depth_type[i]):
                raise ValueError(
                    f"Model requires input (lidar) depth but train dataset "
                    f"{i} ({name}) has no input_depth_type configured")
        transform = None if train else make_transform(mode, aug_cfg, seed)
        common = dict(train=train, data_transform=transform or _untransformed,
                      back_context=cfg.back_context, forward_context=cfg.forward_context)
        if name == "KITTI":
            split, path = cfg.split[i], cfg.path[i]
            ds = KITTIDataset(
                path, split if split.startswith("/") else f"{path}/{split}",
                depth_type=cfg.depth_type[i],
                input_depth_type=(cfg.input_depth_type[i]
                                  if i < len(cfg.input_depth_type) else None),
                with_pose=requirements.get("gt_pose", False),
                **common)
        elif name == "Image":
            ds = ImageFolderDataset(cfg.path[i], split=cfg.split[i] or None, **common)
        elif name == "DGP":
            ds = DDADDataset(cfg.path[i], cfg.split[i], depth_type=cfg.depth_type[i],
                             input_depth_type=(cfg.input_depth_type[i]
                                               if i < len(cfg.input_depth_type) else None),
                             cameras=cfg.cameras[i] if i < len(cfg.cameras) else None,
                             **common)
        elif name == "Synthetic":
            ds = SyntheticSfmDataset(
                seed=seed + i,
                length=cfg.get("synthetic_length", 64),
                height=cfg.get("synthetic_height", 64),
                width=cfg.get("synthetic_width", 96),
                **dict(common, data_transform=transform))
        else:
            raise ValueError(f"Unknown dataset {name}")
        if train:
            repeat = cfg.get("repeat", [1])
            if i < len(repeat) and repeat[i] > 1:
                ds = RepeatDataset(ds, repeat[i])
        datasets.append(ds)
    return datasets


def setup_dataloader(datasets, cfg, mode: str, seed: int = 42, aug_cfg=None):
    """DataLoaders for each dataset of a split. Train drops the last partial
    batch and applies the train transform of ``aug_cfg``; validation and
    test see every sample (the last batch is padded by wrapping and the pad
    rows are masked downstream). Each process loads its shard of every
    split (``parallel/mesh.process_index``, ``process_count``)."""
    from packnet_sfm_tpu_torch.parallel.mesh import process_count, process_index

    transform = make_transform("train", aug_cfg, seed) if mode == "train" else _as_loaded
    return [
        DataLoader(
            d,
            batch_size=cfg.batch_size,
            shuffle=(mode == "train"),
            seed=seed,
            drop_last=(mode == "train"),
            num_workers=cfg.get("num_workers", 8),
            process_index=process_index(),
            process_count=process_count(),
            transform=transform,
        )
        for d in datasets
    ]
