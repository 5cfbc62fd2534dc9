"""The NRS train kind: the program's train step (``engine/train.
make_train_step``) on a Neural Ray Surfaces recipe (GenericSelfSupModel,
RaySurfaceResNet + PoseNet), at the traffic's training ``progress``, and
its check against the plain NRS of ``reference/nrs.py``.

It is the train kind (``kinds/train.py``) with three differences:
- the step is passed the traffic's ``progress``: at progress 0 the ray
  surface's blend coefficient is 0 and its decoder learns nothing, so the
  recipe's mechanism is measured only past it;
- the reference takes the whole batch in one pass: BatchNorm normalises by
  the whole batch's statistics, so it cannot be split into passes;
- the reference's images are rounded as the program's step rounds its
  batch (``batch_dtype``: its network inputs and the loss's images).

The check compares the first steps only (the cell's ``check_steps``): the
NRS objective at T ~ 1e-4 is chaotic, a change at rounding level moves some
soft-argmax correspondences by whole pixels. Besides the train kind's
faults, the program can be broken in two ways the reference is not:
``progress_zero`` (the step run at progress 0: no ray surface) and
``temperature_doubled`` (the projection's temperature twice the recipe's).
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench import weights
from portbench.kinds.train import TrainCell, _norms
from portbench.reference import nets as ref_nets
from portbench.reference import nrs as ref_nrs
from portbench.reference import steps as ref_steps
from portbench.rooflines import softargmax as softargmax_roofline

FAULTS = ("state_unchanged", "half_batch", "progress_zero", "temperature_doubled")
IMAGE_KEYS = ("rgb", "rgb_original", "context", "context_original")


class NrsTrainCell(TrainCell):
    """One run's program side: ``step(i)`` trains on the pool's batch i at
    the traffic's progress."""

    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int, device,
                 make_pool, fault: Optional[str] = None):
        self.progress = float(traffic["progress"])
        self._restore = None
        if fault == "temperature_doubled":
            from packnet_sfm_tpu_torch.models import sfm

            original = sfm.projection_temperature
            sfm.projection_temperature = lambda p: 2.0 * original(p)
            self._restore = (sfm, original)
        try:
            super().__init__(config, traffic, cell, seed, device, make_pool, fault)
        except BaseException:
            self._unpatch()
            raise

    def step(self, i: int) -> None:
        batch = self.pool[i % len(self.pool)]
        if self.fault == "state_unchanged":
            return
        if self.fault == "half_batch":
            batch = {k: [c[: len(c) // 2] for c in v] if isinstance(v, list) else v[: len(v) // 2]
                     for k, v in batch.items()}
        progress = 0.0 if self.fault == "progress_zero" else self.progress
        self._step(self.acc, batch, progress)

    def softargmax_launches(self):
        """[(kernel, least seconds)] of one step's soft-argmax launches."""
        h, w = self.traffic["shape"]
        return softargmax_roofline.step_launches(self.traffic["batch"], h, w,
                                                 self.traffic["contexts"], ref_nrs.PATCH)

    def _unpatch(self) -> None:
        if self._restore is not None:
            module, original = self._restore
            module.projection_temperature = original
            self._restore = None

    def free(self) -> None:
        self._unpatch()
        super().free()

    def _prepare(self, host: dict, dtype):
        batch = ref_steps.prepare(host, self.device, None, dtype)
        if self.config.get("batch_dtype") == "bfloat16":
            for key in IMAGE_KEYS:
                v = batch[key]
                batch[key] = ([c.to(torch.bfloat16).to(dtype) for c in v] if isinstance(v, list)
                              else v.to(torch.bfloat16).to(dtype))
        return batch

    def reference(self, dtype=torch.float64, cast=None, tf32: bool = False):
        """As the train kind's: (losses, first gradient norms, change norms)
        of the reference's first steps, in ``dtype``, each step's batch whole."""
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        m = self.cfg.model
        nets = ref_nrs.build().to(self.device).train()
        weights.load(nets, self.seed)
        nets.to(dtype)
        ref_nets.set_precision(nets, cast)
        named = list(nets.named_parameters())
        lrs = [(m.optimizer.depth if n.startswith("depth_net.") else m.optimizer.pose).lr
               for n, _ in named]
        start = {n: p.detach().clone() for n, p in named}
        adam = ref_steps.Adam([p for _, p in named], lrs)
        losses, grad1 = [], {}
        for i in range(self.check_steps):
            for _, p in named:
                p.grad = None
            loss = ref_nrs.train_loss(nets, self._prepare(self.pool[i], dtype), self.progress)
            loss.backward()
            losses.append(float(loss.detach()))
            grads = [p.grad for _, p in named]
            if i == 0:
                grad1 = _norms((n, g) for (n, _), g in zip(named, grads) if g is not None)
            adam.step(grads)
        change = _norms((n, p.detach() - start[n]) for n, p in named)
        return losses, grad1, change

    def flops_per_step(self) -> float:
        """Convolution and matrix FLOPs of one step of the reference's forward
        and backward at the cell's shapes, counted on the meta device (no
        recomputation: the soft-argmax's chunks are not checkpointed here)."""
        from torch.utils.flop_counter import FlopCounterMode

        nets = ref_nrs.build().to("meta")
        host = self.pool[0]
        rgb = torch.empty(host["rgb"].shape, device="meta")
        ctx = [torch.empty(c.shape, device="meta") for c in host["rgb_context"]]
        batch = {"rgb": rgb, "rgb_original": rgb, "context": ctx, "context_original": ctx}
        with FlopCounterMode(display=False) as counter:
            ref_nrs.train_loss(nets, batch, self.progress, checkpoint=False).backward()
        return float(counter.get_total_flops())


def build(config, traffic, cell, seed, device, make_pool, fault=None) -> NrsTrainCell:
    return NrsTrainCell(config, traffic, cell, seed, device, make_pool, fault)
