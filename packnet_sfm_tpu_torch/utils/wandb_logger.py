"""W&B experiment logger (port of ``packnet_sfm_tpu/utils/wandb_logger.py``).

``wandb`` is imported inside the constructor, only when ``dry_run`` is off;
where it is missing or fails to start, logging turns itself off. Metric
dicts are buffered and flushed when the global step moves on; depth and rgb
panels are logged as images.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class WandbLogger:
    def __init__(self, name: str = "", project: str = "", entity: str = "",
                 tags=None, dir: str = "", dry_run: bool = True, **kwargs):
        self.dry_run = dry_run
        self._wandb = None
        self._metrics: Dict = {}
        self._step = -1
        if not dry_run:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(name=name or None, project=project or None,
                           entity=entity or None, tags=tags or None,
                           dir=dir or None)
            except Exception as e:  # noqa: BLE001 -- any failure to start turns logging off
                print(f"wandb unavailable ({e}); logging disabled")
                self._wandb = None
                self.dry_run = True

    @property
    def run_name(self) -> Optional[str]:
        return self._wandb.run.name if self._wandb else None

    @property
    def run_url(self) -> Optional[str]:
        return self._wandb.run.get_url() if self._wandb else None

    def log_config(self, config: Dict):
        if self._wandb:
            self._wandb.config.update(config, allow_val_change=True)

    def log_metrics(self, metrics: Dict, step: int):
        """Buffer metrics, flushing when the global step advances."""
        if self.dry_run:
            return
        if step != self._step and self._metrics:
            self._wandb.log(self._metrics, step=self._step)
            self._metrics = {}
        self._step = step
        self._metrics.update(metrics)

    def log_depth_images(self, rgb: np.ndarray, inv_depth: np.ndarray,
                         gt_depth: Optional[np.ndarray], prefix: str, step: int):
        """Log rgb, predicted inverse depth and (where given) ground-truth
        inverse depth panels."""
        if self.dry_run:
            return
        from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth

        images = {
            f"{prefix}-rgb": self._wandb.Image((rgb * 255).astype(np.uint8)),
            f"{prefix}-inv_depth": self._wandb.Image(
                (viz_inv_depth(inv_depth[..., 0]) * 255).astype(np.uint8)),
        }
        if gt_depth is not None:
            inv_gt = np.where(gt_depth[..., 0] > 0, 1.0 / np.clip(gt_depth[..., 0], 1e-6, None), 0)
            images[f"{prefix}-gt_inv_depth"] = self._wandb.Image(
                (viz_inv_depth(inv_gt, filter_zeros=True) * 255).astype(np.uint8))
        self._wandb.log(images, step=step)

    def finish(self):
        if self._wandb:
            self._wandb.finish()
