"""Trainer (port of ``packnet_sfm_tpu/engine/trainer.py``): epoch
orchestration over the train and eval steps.

``Trainer(config, device="cuda")`` builds the model (weights drawn from
``arch.seed``; no sample batch is needed), the metrics config, the
validation and test datasets and loaders, the eval step and, where
``wandb.dry_run`` is off, the W&B logger. The training half (the train
datasets and loaders, ``steps_per_epoch`` over every train loader, Adam and
its per-step schedule, the top-k checkpoint manager) is built at the first
``fit`` or ``train_epoch``, so that evaluating a checkpoint never reads its
train split.

- ``fit``: ``validate_first``, then epochs ``current_epoch`` ..
  ``max(max_epochs, min_epochs) - 1``, each one ``train_epoch``, the
  validation table, the W&B metrics and ``check_and_save`` on {loss,
  <mode>_<metric>, <di>-<mode>_<metric>}; with a profile directory, epoch 1
  is traced with ``torch.profiler`` (``epoch_001.json``) and its steps'
  spans recorded (``engine/spans.py``): each span's mean host ms and self
  ms a step, and the step counters, in ``epoch_001_spans.json``.
- ``train_epoch``: progressive scale count, one train step a batch, the
  device-side metric sums read once at the end, images/s (a multi-camera
  batch of B samples of N cameras counts B*N images).
- A multi-camera batch (DGP) is folded to [B*N, ...]
  (``models/batch_utils.stack_multicam_batch``) before a train or eval
  step takes it; ``validate`` averages a sample's N metric rows.
- Preemption: SIGTERM/SIGINT set a flag; the epoch drains at the next batch
  boundary and ``fit`` writes ``preempt_epoch=NN.ckpt`` recorded as epoch
  NN - 1, so that a resume redoes the interrupted epoch.
- ``resume``: the model, and for training the optimizer, the scheduler,
  the step and the state of the CPU generator that draws the training flip
  (seeded from ``arch.seed + 1``, as the JAX package's ``TrainState.rng``):
  a run of N epochs equals N1 epochs, a save, a resume and N - N1 epochs,
  bit for bit on the CPU.

``arch.dtype: bfloat16`` builds the model with the bfloat16 compute dtype
(``engine/factory.setup_model``) and the train steps cast their batches'
network inputs to it, as the JAX trainer does (the targets and intrinsics
stay float32: ``engine/train.cast_batch``); evaluation casts nothing beyond
the model. The train split loads what the model kind needs (ground-truth
depth for the supervised kinds, input depth for completion, the context
poses for VelSup); ``validate`` hands the eval step every input of the depth
network that a batch holds (PackNet-SAN's input depth).

With more than one process (``parallel/mesh.init_distributed``; one
device a rank, which the caller passes), every rank loads its shard of each
split and steps on its rows of the global batch (``engine/train.
make_train_step``), and the ranks agree where the JAX package's one global
program agrees by construction:
- the W&B logger runs on rank 0 only, and its run name, URL and checkpoint
  path reach every rank before the checkpoint manager is built;
- ``train_epoch`` asks every ``arch.preempt_sync_every`` batches (default
  8) whether any rank was signalled, and ``fit`` once more at the epoch's
  end, so that every rank drains at the same batch; the epoch's metric
  sums are summed across ranks once an epoch, so 'loss' is the global
  batch's ('imgs_per_sec' stays this rank's);
- ``validate`` sums the metric rows and seen-counts across ranks before it
  checks that every sample was seen;
- checkpoints are written by rank 0 (``engine/checkpoint``), whose
  decision and path every rank takes; the emergency save too;
- the epoch line and the metric tables print on rank 0.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.datasets.loader import setup_dataloader, setup_dataset
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.engine import spans
from packnet_sfm_tpu_torch.engine.checkpoint import (
    ModelCheckpoint,
    load_network,
    load_pretrained_encoder,
    restore_checkpoint,
    save_checkpoint,
)
from packnet_sfm_tpu_torch.engine.factory import (
    compute_dtype,
    make_optimizer,
    setup_metrics_config,
    setup_model,
)
from packnet_sfm_tpu_torch.engine.metrics import METRIC_NAMES
from packnet_sfm_tpu_torch.engine.train import (
    EVAL_MODES,
    METRIC_KEYS,
    make_eval_step,
    make_train_step,
    zero_metrics,
)
from packnet_sfm_tpu_torch.losses.progressive import progressive_num_scales
from packnet_sfm_tpu_torch.models.batch_utils import stack_multicam_batch
from packnet_sfm_tpu_torch.parallel.mesh import (
    all_reduce_host_sum,
    any_process_flag,
    broadcast_object,
    process_count,
    process_index,
)

_TRAIN_STATE_KEYS = ("optimizer", "scheduler", "generator")


class Trainer:
    """Training and evaluation loops built from a config tree."""

    def __init__(self, config: ConfigNode, device="cuda", profile_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.config = config
        self.seed = config.arch.seed
        self.max_epochs = config.arch.max_epochs
        # a floor on the epoch count, as in the JAX package
        self.min_epochs = config.arch.get("min_epochs", 0)
        self.current_epoch = 0
        self.profile_dir = profile_dir
        self.dtype = compute_dtype(config)
        self.model = setup_model(config.model, device=self.device, seed=self.seed,
                                 dtype=self.dtype)
        self.metrics_cfg = setup_metrics_config(config)
        aug = config.datasets.augmentation
        self.val_datasets = setup_dataset(config.datasets.validation, "validation", aug,
                                          self.seed)
        self.test_datasets = setup_dataset(config.datasets.test, "test", aug, self.seed)
        self.val_loaders = setup_dataloader(self.val_datasets, config.datasets.validation,
                                            "validation", self.seed)
        self.test_loaders = setup_dataloader(self.test_datasets, config.datasets.test,
                                             "test", self.seed)
        self.eval_step = make_eval_step(self.model, self.metrics_cfg)

        # the training half, built by _setup_training
        self.train_datasets = self.train_loaders = None
        self.steps_per_epoch = None
        self.optimizer = self.scheduler = self.checkpoint = None
        self.generator = torch.Generator().manual_seed(self.seed + 1)
        self.step = 0
        self.history: List[Dict] = []
        self._train_steps: Dict[int, callable] = {}
        self._resumed: Dict = {}
        self._state_ready = False
        self._preempt_requested = False

        self.logger = None
        if process_index() == 0 and not config.wandb.get("dry_run", True):
            from packnet_sfm_tpu_torch.utils.wandb_logger import WandbLogger

            self.logger = WandbLogger(**config.wandb.to_dict())
            self.logger.log_config(config.to_dict())
            # adopt the run name into the config, and into the checkpoint
            # path as a subdirectory of it
            if self.logger.run_name:
                run_name = self.logger.run_name
                config.name = run_name
                config.wandb.name = run_name
                if self.logger.run_url:
                    config.wandb.url = self.logger.run_url
                if config.checkpoint.get("filepath"):
                    config.checkpoint.filepath = os.path.join(config.checkpoint.filepath,
                                                              run_name)
                self.logger.log_config(config.to_dict())
        if process_count() > 1:
            # rank 0's run name and checkpoint path on every rank
            names = broadcast_object(dict(name=config.get("name", ""),
                                          wandb=dict(config.wandb.to_dict()),
                                          filepath=config.checkpoint.get("filepath", "")))
            config.name = names["name"]
            config.wandb.update(names["wandb"])
            config.checkpoint.filepath = names["filepath"]

    # ------------------------------------------------------------------ state

    def _setup_training(self):
        """Build the training half once: the train split (with the model's
        train-data requirements), its loaders, the optimizer and schedule
        over ``steps_per_epoch`` and the checkpoint manager, whose monitor
        must be a metric that ``fit`` hands it."""
        if self.train_loaders is not None:
            return
        config = self.config
        name = config.model.name
        requirements = {"gt_pose": name == "VelSupModel",
                        "gt_depth": name in ("SemiSupModel", "SemiSupCompletionModel"),
                        "input_depth": name == "SemiSupCompletionModel"}
        self.train_datasets = setup_dataset(config.datasets.train, "train",
                                            config.datasets.augmentation, self.seed, requirements)
        self.train_loaders = setup_dataloader(self.train_datasets, config.datasets.train,
                                              "train", self.seed, config.datasets.augmentation)
        self.steps_per_epoch = sum(len(loader) for loader in self.train_loaders) or 1
        self.optimizer, self.scheduler = make_optimizer(
            self.model, config.model.optimizer, config.model.scheduler, self.steps_per_epoch)
        ckpt_dir = config.checkpoint.get("filepath") or ""
        if ckpt_dir:
            self.checkpoint = ModelCheckpoint(
                ckpt_dir, monitor=config.checkpoint.monitor,
                save_top_k=config.checkpoint.save_top_k, mode=config.checkpoint.mode,
                s3_path=config.checkpoint.get("s3_path", ""),
                s3_frequency=config.checkpoint.get("s3_frequency", 1))
            self.checkpoint.check_monitor(self._checkpoint_metric_names())
        self._apply_resumed()

    def _checkpoint_metric_names(self) -> List[str]:
        names = ["loss"]
        for di in range(len(self.val_loaders)):
            for m in EVAL_MODES:
                for metric in METRIC_NAMES:
                    names += [f"{m}_{metric}", f"{di}-{m}_{metric}"]
        return names

    def _apply_resumed(self):
        """Load the train state that ``resume`` read into the optimizer, the
        scheduler and the flip generator, once they exist."""
        if self.optimizer is None:
            return
        resumed, self._resumed = self._resumed, {}
        if "optimizer" in resumed:
            self.optimizer.load_state_dict(resumed["optimizer"])
        if "scheduler" in resumed:
            self.scheduler.load_state_dict(resumed["scheduler"])
        if "generator" in resumed:
            self.generator.set_state(resumed["generator"])

    def init_state(self, sample_batch: Optional[Dict] = None):
        """The init-time loads over the seed's weights: ImageNet encoder
        weights for '<N>pt' versions of the ResNet networks (from
        ``pretrained_path`` or ``$PN_PRETRAINED_DIR/resnet<N>.npz``; without
        either, a warning and training from scratch), then the per-network
        and whole-model ``checkpoint_path`` loads."""
        del sample_batch            # the weights exist already; no shapes are needed
        model_cfg = self.config.model
        for net in ("depth_net", "pose_net"):
            net_cfg = model_cfg[net]
            version = net_cfg.get("version", "") or ""
            if not version.endswith("pt") or net_cfg.get("name") not in (
                    "DepthResNet", "PoseResNet", "RaySurfaceResNet"):
                continue
            depth = version[:-2] or "18"
            path = net_cfg.get("pretrained_path", "")
            if not path:
                pre_dir = os.environ.get("PN_PRETRAINED_DIR", "")
                cand = os.path.join(pre_dir, f"resnet{depth}.npz")
                path = cand if pre_dir and os.path.exists(cand) else ""
            if path:
                n_images = 2 if net_cfg.get("name") == "PoseResNet" else 1
                load_pretrained_encoder(path, self.model, net, num_input_images=n_images)
            else:
                print(f"### WARNING: {net} version {version} requests "
                      "ImageNet weights but no pretrained artifact was found "
                      f"(set model.{net}.pretrained_path or "
                      "$PN_PRETRAINED_DIR); training from scratch")
        for net in ("depth_net", "pose_net"):
            ckpt = model_cfg[net].get("checkpoint_path", "")
            if ckpt:
                load_network(ckpt, self.model, net)
        if model_cfg.get("checkpoint_path"):
            for net in ("depth_net", "pose_net"):
                load_network(model_cfg.checkpoint_path, self.model, net)
        self._state_ready = True
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"### Initialized model with {n_params / 1e6:.2f}M parameters")

    def resume(self, ckpt_path: str):
        """Restore the model's weights, the epoch and the step from a
        checkpoint, and, for training, the optimizer, the scheduler and the
        flip generator."""
        state, meta = restore_checkpoint(ckpt_path, self.model)
        self.current_epoch = meta["epoch"] + 1
        self.step = int(meta.get("step", 0))
        self._resumed = {k: state[k] for k in _TRAIN_STATE_KEYS if k in state}
        self._apply_resumed()
        self._state_ready = True
        print(f"### Resumed from {ckpt_path} at epoch {self.current_epoch}")

    def _train_state(self) -> Dict:
        return dict(step=self.step, optimizer=self.optimizer, scheduler=self.scheduler,
                    generator=self.generator)

    def _train_step_for(self, num_scales: int):
        if num_scales not in self._train_steps:
            self._train_steps[num_scales] = make_train_step(
                self.model, self.optimizer, self.scheduler, num_scales=num_scales,
                grad_accum=self.config.arch.get("grad_accum", 1), generator=self.generator,
                compute_dtype=self.dtype or torch.float32)
        return self._train_steps[num_scales]

    # ------------------------------------------------------------------ loops

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch over every train loader: the mean of each metric over
        the steps, 'imgs_per_sec', 'seconds' and, on the card, 'peak_mib'
        (the epoch's peak of allocated device memory). Stops at the first
        batch boundary after a preemption request; with more than one
        process, at the first agreed one (see the module docstring), and the
        metric means are the global batch's."""
        self._setup_training()
        progress = epoch / max(self.max_epochs, 1)
        loss_cfg = self.config.model.loss
        num_scales = progressive_num_scales(progress, loss_cfg.num_scales,
                                            loss_cfg.progressive_scaling)
        step_fn = self._train_step_for(num_scales)
        acc = zero_metrics(self.device)
        images = 0
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        multi = process_count() > 1
        sync_every = max(int(self.config.arch.get("preempt_sync_every", 8)), 1)
        stop = False
        t0 = time.perf_counter()
        for loader in self.train_loaders:
            for bi, batch in enumerate(loader.epoch(epoch)):
                # one small collective every sync_every batches keeps the
                # ranks' drain at one batch boundary
                stop = (bi % sync_every == 0 and any_process_flag(self._preempt_requested)
                        if multi else self._preempt_requested)
                if stop:
                    break
                batch = stack_multicam_batch(batch)
                acc = step_fn(acc, batch, progress)
                self.step += 1
                images += batch["rgb"].shape[0]
            if stop:
                break
        self._preempt_requested |= stop
        # one read of the device-side sums per epoch, summed across processes
        sums = all_reduce_host_sum(torch.stack([acc[k] for k in METRIC_KEYS]).cpu().numpy())
        dt = time.perf_counter() - t0
        avg = {k: float(v[0] / max(v[1], 1.0)) for k, v in zip(METRIC_KEYS, sums) if v[1] > 0}
        avg["imgs_per_sec"] = images / dt if dt > 0 else 0.0
        avg["seconds"] = dt
        if cuda:
            avg["peak_mib"] = torch.cuda.max_memory_allocated(self.device) / 2**20
        return avg

    def validate(self, epoch: int, loaders: Optional[List] = None,
                 save_folder: Optional[str] = None) -> List[Dict]:
        """The eval protocol (reference utils/reduce.py:31-80 and
        horovod_trainer.py:105-155):

        - every sample is evaluated exactly once (loaders pad the last batch
          by wrapping; pad rows are masked out here on the host);
        - per-sample [B, 7] metric rows are scattered by dataset index;
        - rows and seen-counts are summed across processes, every index must
          be seen at least once, and the mean is taken over rows / seen, so
          duplicates (a pad row wrapped onto another process) never skew
          the result.
        """
        loaders = loaders if loaders is not None else self.val_loaders
        results = []
        for di, loader in enumerate(loaders):
            n_total = len(loader.dataset)
            rows = {m: np.zeros((n_total, 7), np.float64) for m in EVAL_MODES}
            seen = np.zeros(n_total, np.float64)
            has_depth = False
            log_interval = max(len(loader) // max(
                int(self.config.wandb.get("num_logs", 5)), 1), 1)
            for bi, batch in enumerate(loader.epoch(epoch)):
                if "depth" not in batch:
                    continue
                has_depth = True
                idx = np.asarray(batch["idx"])
                bsz = len(idx) - int(batch.get("pad_count", 0))
                folded = stack_multicam_batch(batch)
                out = self.eval_step(folded)
                for m in EVAL_MODES:
                    r = out[m].cpu().numpy()               # [B*cams, 7]
                    if r.shape[0] != len(idx):             # multi-camera batches:
                        k = r.shape[0] // len(idx)         # one row per sample =
                        r = r.reshape(len(idx), k, 7).mean(axis=1)  # camera mean
                    rows[m][idx[:bsz]] = r[:bsz]
                seen[idx[:bsz]] += 1.0
                if save_folder:
                    self._save_depth_outputs(save_folder, batch, out, bsz)
                if self.logger is not None and bi % log_interval == 0 and bsz > 0:
                    self.logger.log_depth_images(
                        np.asarray(folded["rgb"][0]), out["inv_depth"][0].cpu().numpy(),
                        np.asarray(folded["depth"][0]), prefix=f"val{di}-batch{bi}",
                        step=self.step)
            if not has_depth:
                # an all-zero metric table would hide a misconfigured split
                raise ValueError(
                    f"Eval dataset {di} yielded no ground-truth depth: check "
                    "the split's depth_type configuration (every batch was "
                    "missing the 'depth' key)")
            reduced = all_reduce_host_sum({"rows": rows, "seen": seen})
            rows, seen = reduced["rows"], reduced["seen"]
            if np.any(seen == 0):
                raise AssertionError("Not all samples were seen during evaluation")
            results.append(
                {m: (rows[m] / seen[:, None]).mean(axis=0) for m in EVAL_MODES})
        return results

    def _save_depth_outputs(self, folder: str, batch, out, bsz: int):
        """Test-time depth writers (reference utils/save.py:11): npz/png
        depth and the rgb/viz side-by-side image, as save.depth says."""
        from packnet_sfm_tpu_torch.utils.save import write_depth

        flags = self.config.save.depth
        inv_depth = out["inv_depth"].cpu().numpy()
        names = batch.get("filename") or [
            f"sample_{int(i):010d}" for i in batch.get("idx", range(bsz))]
        for i in range(bsz):
            base = os.path.join(folder, str(names[i]))
            depth_i = 1.0 / np.clip(inv_depth[i, ..., 0], 1e-6, None)
            if flags.get("npz", True):
                write_depth(base + ".npz", depth_i, intrinsics=batch["intrinsics"][i])
            if flags.get("png", True):
                write_depth(base + ".png", depth_i)
            if flags.get("viz", True) or flags.get("rgb", True):
                save_side_by_side(base + "_viz.png", inv_depth[i, ..., 0],
                                  np.asarray(batch["rgb"][i]) if flags.get("rgb", True) else None,
                                  viz=flags.get("viz", True))

    def _install_preemption_handlers(self) -> Dict:
        """SIGTERM/SIGINT set the preemption flag; returns the handlers they
        replace (none where this is not the main thread)."""
        import signal

        def handler(signum, _frame):
            self._preempt_requested = True
            print(f"### Caught signal {signum}: checkpointing at the next "
                  "batch boundary, then exiting", flush=True)

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass                # not the main thread (e.g. under a test runner)
        return previous

    def _emergency_save(self, epoch: int) -> str:
        """Checkpoint the live state mid-run, recorded as epoch - 1, so that
        ``cli.train <path>`` redoes the interrupted epoch. Every process
        calls it; rank 0 writes (``save_checkpoint``)."""
        ckpt_dir = (self.config.checkpoint.get("filepath")
                    or os.path.join(tempfile.gettempdir(), "packnet_sfm_preempt"))
        path = os.path.join(ckpt_dir, f"preempt_epoch={epoch:02d}.ckpt")
        save_checkpoint(path, self.model, self.config.to_dict(), epoch - 1,
                        **self._train_state())
        saved = f": saved {path}; resume with `cli.train {path}`" if process_index() == 0 else ""
        print(f"### Preempted at step {self.step}{saved}", flush=True)
        return path

    def fit(self) -> List[Dict]:
        """The training loop; returns ``history``, one record an epoch
        (loss, images/s, train and validation seconds, the metric tables)."""
        import signal

        previous = self._install_preemption_handlers()
        try:
            self._setup_training()
            if not self._state_ready:
                self.init_state()
            if self.config.arch.get("validate_first"):
                self._print_tables(self.validate(0))
            for epoch in range(self.current_epoch, max(self.max_epochs, self.min_epochs)):
                if self._fit_epoch(epoch):
                    break
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        return self.history

    def _fit_epoch(self, epoch: int) -> bool:
        """Train, validate, log and checkpoint one epoch; True where it was
        preempted (after the emergency save)."""
        if self.profile_dir and epoch == 1:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof, spans.recording() as records:
                train_metrics = self.train_epoch(epoch)
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.profile_dir, f"epoch_{epoch:03d}.json"))
            with open(os.path.join(self.profile_dir, f"epoch_{epoch:03d}_spans.json"), "w") as f:
                json.dump(spans.summary(records), f, indent=1)
        else:
            train_metrics = self.train_epoch(epoch)
        # agreed once more: a signal after the epoch's last check must not
        # drain one process while the others validate
        if any_process_flag(self._preempt_requested):
            self._preempt_requested = True
            self._emergency_save(epoch)
            return True
        t0 = time.perf_counter()
        val_metrics = self.validate(epoch)
        val_seconds = time.perf_counter() - t0
        peak = (f" | peak {train_metrics['peak_mib']:.1f} MiB" if "peak_mib" in train_metrics
                else "")
        if process_index() == 0:
            print(f"Epoch {epoch:03d} | loss {train_metrics.get('loss', 0):.4f} | "
                  f"{train_metrics['imgs_per_sec']:.1f} imgs/s | "
                  f"{train_metrics['seconds']:.1f} s train, {val_seconds:.1f} s validation{peak}")
        self._print_tables(val_metrics)
        if self.logger is not None:
            logged = {f"train/{k}": v for k, v in train_metrics.items()}
            for di, res in enumerate(val_metrics):
                for m in EVAL_MODES:
                    for mi, name in enumerate(METRIC_NAMES):
                        logged[f"val{di}/{m}/{name}"] = float(res[m][mi])
            self.logger.log_metrics(logged, self.step)
        if self.checkpoint is not None:
            flat = {"loss": train_metrics.get("loss", 0.0)}
            for di, res in enumerate(val_metrics):
                for m in EVAL_MODES:
                    for mi, name in enumerate(METRIC_NAMES):
                        flat[f"{m}_{name}"] = float(res[m][mi])
                        flat[f"{di}-{m}_{name}"] = float(res[m][mi])
            self.checkpoint.check_and_save(self.model, self.config.to_dict(), epoch, flat,
                                           **self._train_state())
        self.history.append(dict(epoch=epoch, val_seconds=val_seconds,
                                 val=[{m: [float(x) for x in res[m]] for m in EVAL_MODES}
                                      for res in val_metrics],
                                 **train_metrics))
        self.current_epoch = epoch + 1
        return False

    def test(self) -> List[Dict]:
        save_folder = self.config.save.get("folder", "")
        results = self.validate(0, loaders=self.test_loaders,
                                save_folder=save_folder or None)
        self._print_tables(results)
        return results

    # ---------------------------------------------------------------- output

    def _print_tables(self, results: List[Dict]):
        if process_index() == 0:
            self.print_metrics(results)

    @staticmethod
    def print_metrics(results: List[Dict]):
        """ASCII metric table (reference model_wrapper.py:319-371)."""
        header = "| {:>12} | " + " | ".join(f"{n:>8}" for n in METRIC_NAMES) + " |"
        bar = "-" * len(header.format(""))
        for di, res in enumerate(results):
            print(bar)
            print(header.format(f"dataset {di}"))
            print(bar)
            for mode in EVAL_MODES:
                row = "| {:>12} | ".format(mode) + " | ".join(
                    f"{v:8.3f}" for v in res[mode]) + " |"
                print(row)
            print(bar)


def save_side_by_side(filename: str, inv_depth: np.ndarray, rgb: Optional[np.ndarray] = None,
                      viz: bool = True):
    """Write ``rgb`` (resized to the map, LANCZOS) above the colormapped
    inverse depth [H, W] as one PNG; either panel may be left out."""
    from PIL import Image

    from packnet_sfm_tpu_torch.datasets.augmentations import resize_image
    from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth

    colored = viz_inv_depth(inv_depth)
    panels = []
    if rgb is not None:
        if rgb.shape[:2] != colored.shape[:2]:
            rgb = resize_image(rgb, colored.shape[:2])
        panels.append(rgb)
    if viz:
        panels.append(colored)
    img = (np.concatenate(panels, axis=0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    Image.fromarray(img).save(filename)
