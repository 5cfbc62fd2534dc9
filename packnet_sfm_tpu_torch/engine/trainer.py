"""Trainer (port of ``packnet_sfm_tpu/engine/trainer.py``): the eval half.

``Trainer(config, device="cuda")`` builds the model (weights drawn from
``arch.seed``; no sample batch is needed), the metrics config, the
validation and test datasets and loaders, and the eval step. Ported:
``resume``, ``validate`` (the whole eval protocol), ``test`` and
``print_metrics``. Training (``fit``, ``train_epoch``, preemption, the
pretrained and partial loads of ``init_state``) and W&B logging wait for the
trainer slice, and ``arch.dtype: bfloat16`` for the bf16 slice; each raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from packnet_sfm_tpu_torch.core.config import ConfigNode
from packnet_sfm_tpu_torch.datasets.loader import setup_dataloader, setup_dataset
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint
from packnet_sfm_tpu_torch.engine.factory import setup_metrics_config, setup_model
from packnet_sfm_tpu_torch.engine.metrics import METRIC_NAMES
from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, make_eval_step

_TRAINER_SLICE = "see ROADMAP.md §1 item 2 (the trainer slice)"


class Trainer:
    """Evaluation front end built from a config tree."""

    def __init__(self, config: ConfigNode, device="cuda"):
        self.device = resolve_device(device)
        if config.arch.get("dtype", "float32") == "bfloat16":
            raise NotImplementedError(
                "arch.dtype bfloat16 is not ported yet (the port computes in float32); "
                "see ROADMAP.md §1 item 3")
        if not config.wandb.get("dry_run", True):
            raise NotImplementedError(f"W&B logging is not ported yet; {_TRAINER_SLICE}")
        self.config = config
        self.seed = config.arch.seed
        self.current_epoch = 0
        self.model = setup_model(config.model, device=self.device, seed=self.seed)
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

    # ------------------------------------------------------------------ state

    def init_state(self, sample_batch: Optional[Dict] = None):
        """The weights are drawn when the trainer is built; what the JAX
        ``init_state`` adds to them, ImageNet encoder weights and
        per-network checkpoint loads, is not ported yet and raises."""
        del sample_batch
        model_cfg = self.config.model
        for net in ("depth_net", "pose_net"):
            net_cfg = model_cfg[net]
            if net_cfg.get("checkpoint_path") or model_cfg.get("checkpoint_path"):
                raise NotImplementedError(
                    f"partial checkpoint loads into {net} are not ported yet; {_TRAINER_SLICE}")
            if (net_cfg.get("version", "") or "").endswith("pt"):
                raise NotImplementedError(
                    f"ImageNet encoder weights for {net} are not ported yet; {_TRAINER_SLICE}")

    def resume(self, ckpt_path: str):
        """Restore the model's weights and the epoch from a checkpoint."""
        _, meta = restore_checkpoint(ckpt_path, self.model)
        self.current_epoch = meta["epoch"] + 1
        print(f"### Resumed from {ckpt_path} at epoch {self.current_epoch}")

    # ------------------------------------------------------------------ loops

    def train_epoch(self, epoch: int):
        raise NotImplementedError(f"training is not ported yet; {_TRAINER_SLICE}")

    def fit(self):
        raise NotImplementedError(f"training is not ported yet; {_TRAINER_SLICE}")

    def validate(self, epoch: int, loaders: Optional[List] = None,
                 save_folder: Optional[str] = None) -> List[Dict]:
        """The eval protocol (reference utils/reduce.py:31-80 and
        horovod_trainer.py:105-155):

        - every sample is evaluated exactly once (loaders pad the last batch
          by wrapping; pad rows are masked out here on the host);
        - per-sample [B, 7] metric rows are scattered by dataset index;
        - every index must be seen at least once, and the mean is taken over
          rows / seen, so duplicates never skew the result.

        With one process, the cross-process sum of rows and seen-counts is
        the identity (multi-process eval comes with ROADMAP.md §1 item 5).
        """
        loaders = loaders if loaders is not None else self.val_loaders
        results = []
        for di, loader in enumerate(loaders):
            n_total = len(loader.dataset)
            rows = {m: np.zeros((n_total, 7), np.float64) for m in EVAL_MODES}
            seen = np.zeros(n_total, np.float64)
            has_depth = False
            for batch in loader.epoch(epoch):
                if "depth" not in batch:
                    continue
                has_depth = True
                idx = np.asarray(batch["idx"])
                bsz = len(idx) - int(batch.get("pad_count", 0))
                out = self.eval_step(batch)
                for m in EVAL_MODES:
                    r = out[m].cpu().numpy()               # [B*cams, 7]
                    if r.shape[0] != len(idx):             # multi-camera batches:
                        k = r.shape[0] // len(idx)         # one row per sample =
                        r = r.reshape(len(idx), k, 7).mean(axis=1)  # camera mean
                    rows[m][idx[:bsz]] = r[:bsz]
                seen[idx[:bsz]] += 1.0
                if save_folder:
                    self._save_depth_outputs(save_folder, batch, out, bsz)
            if not has_depth:
                # an all-zero metric table would hide a misconfigured split
                raise ValueError(
                    f"Eval dataset {di} yielded no ground-truth depth: check "
                    "the split's depth_type configuration (every batch was "
                    "missing the 'depth' key)")
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

    def test(self) -> List[Dict]:
        save_folder = self.config.save.get("folder", "")
        results = self.validate(0, loaders=self.test_loaders,
                                save_folder=save_folder or None)
        self.print_metrics(results)
        return results

    # ---------------------------------------------------------------- output

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
