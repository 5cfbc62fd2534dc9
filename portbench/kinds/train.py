"""The train kind: the program's train step (``engine/train.make_train_step``)
on the configuration's ``train`` recipe, and its check against the
reference.

Set-up builds the step once, with its model and Adam state, and drives it
through its first steps (the cell's ``check_steps``, 3 unless it says 2) on
as many distinct batches of the pool: the same call and feed as the
window's, which they warm up. From those steps it keeps each step's loss
(the step's accumulator, read after each), each leaf's norm of the first
gradient (Adam's first moment after one step, over 1 - beta1) and, after
the last, each leaf's norm of the change from the seed's weights. The
window goes on from that state. After the window, with the program's state
freed, the reference (``portbench/reference``) takes the same steps from
the same weights on the same batches, with the same flip draws, in float64
(no cuDNN algorithm choice or TF32 moves its answer), and the run compares.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench import weights, yardstick
from portbench.reference import nets as ref_nets
from portbench.reference import steps as ref_steps
from portbench.rooflines import warp as warp_roofline

BETA1 = 0.9
# samples a reference pass takes at once: float64 activations of more than 4
# images at 192x640 do not fit the card
REFERENCE_MICROBATCH = 4


def _norms(named) -> Dict[str, float]:
    named = list(named)
    if not named:
        return {}
    names, tensors = zip(*named)
    return dict(zip(names, torch.stack([t.double().norm() for t in tensors]).tolist()))


class TrainCell:
    """One run's program side: ``step(i)`` trains on the pool's batch i."""

    min_steps = 1

    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int, device,
                 make_pool, fault: Optional[str] = None):
        from packnet_sfm_tpu_torch.core.config import config_from_dict
        from packnet_sfm_tpu_torch.engine.factory import (
            compute_dtype, make_optimizer, setup_model)
        from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

        self.config, self.traffic, self.cell = config, traffic, cell
        self.seed, self.device = seed, device
        recipe = config[cell["recipe"]]
        cfg = config_from_dict(recipe)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg) or torch.float32
        self.model = setup_model(cfg.model, device=device, seed=0,
                                 dtype=None if self.dtype == torch.float32 else self.dtype)
        weights.load(self.model, seed)
        # no epoch ends inside a run: the schedule's factor stays 1
        self.optimizer, scheduler = make_optimizer(self.model, cfg.model.optimizer,
                                                   cfg.model.scheduler, 10 ** 9)
        self._step = make_train_step(self.model, self.optimizer, scheduler,
                                     generator=torch.Generator().manual_seed(int(seed)),
                                     compute_dtype=self.dtype)
        self.acc = zero_metrics(device)
        self.pool = make_pool(traffic, seed, device)
        self.fault = fault
        self.check_steps = cell.get("check_steps", 3)
        self.losses, self.grad1, self.change = [], {}, {}
        self._first_steps()

    # ---- the step that the window drives ------------------------------------
    def step(self, i: int) -> None:
        batch = self.pool[i % len(self.pool)]
        if self.fault == "state_unchanged":
            return
        if self.fault == "half_batch":
            batch = {k: [c[: len(c) // 2] for c in v] if isinstance(v, list) else v[: len(v) // 2]
                     for k, v in batch.items()}
        self._step(self.acc, batch)

    def _first_steps(self) -> None:
        """The first ``check_steps`` steps on as many pool batches, with the
        readings the check compares."""
        named = list(self.model.named_parameters())
        before = 0.0
        for i in range(self.check_steps):
            self.step(i)
            total = float(self.acc["loss"][0])
            self.losses.append(total - before)
            before = total
            if i == 0:
                state = self.optimizer.state
                self.grad1 = _norms((n, state[p]["exp_avg"] / (1 - BETA1))
                                    for n, p in named if "exp_avg" in state.get(p, {}))
        start = weights.draw(named, self.seed, self.device)
        self.change = _norms((n, p.detach() - start[n]) for n, p in named)

    # ---- what the run reports beside the rate ---------------------------------
    def images_per_step(self) -> int:
        return self.traffic["batch"]

    def warp_launches(self):
        """[(kernel, least seconds)] of one step's warp launches, where the
        recipe warps (the self-supervised kinds)."""
        if self.cfg.model.name != "SelfSupModel":
            return []
        h, w = self.traffic["shape"]
        itemsize = 2 if self.dtype == torch.bfloat16 else 4
        return warp_roofline.step_launches(self.traffic["batch"], h, w,
                                           self.traffic["contexts"], 4, itemsize)

    def free(self) -> None:
        del self.model, self.optimizer, self._step, self.acc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference -----------------------------------------------------
    def reference(self, dtype=torch.float64, cast=None, tf32: bool = False):
        """The reference's readings of the first steps: (losses, first
        gradient norms, change norms), computed in ``dtype`` (the seed's
        float32 weights widened), with ``cast`` on every convolution (None:
        none) and TF32 as ``tf32`` says."""
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        m = self.cfg.model
        nets = ref_steps.build(m.depth_net.name, bool(m.pose_net.get("name")))
        nets.to(self.device).train()
        weights.load(nets, self.seed)
        nets.to(dtype)
        ref_nets.set_precision(nets, cast)
        named = list(nets.named_parameters())
        lrs = [(m.optimizer.depth if n.startswith("depth_net.") else m.optimizer.pose).lr
               for n, _ in named]
        start = {n: p.detach().clone() for n, p in named}
        adam = ref_steps.Adam([p for _, p in named], lrs)
        flips = torch.Generator().manual_seed(int(self.seed))
        batch_dtype = torch.bfloat16 if self.config.get("batch_dtype") == "bfloat16" else None
        micro = min(self.traffic["batch"], REFERENCE_MICROBATCH)
        losses, grad1 = [], {}
        for i in range(self.check_steps):
            host = self.pool[i]
            flip = torch.rand((), generator=flips).item() < m.loss.flip_lr_prob
            for _, p in named:
                p.grad = None
            total = 0.0
            parts = self.traffic["batch"] // micro
            for j in range(parts):
                part = {k: [c[j * micro:(j + 1) * micro] for c in v] if isinstance(v, list)
                        else v[j * micro:(j + 1) * micro] for k, v in host.items()}
                batch = ref_steps.prepare(part, self.device, batch_dtype, dtype)
                loss = ref_steps.train_loss(m.name, nets, batch, flip) / parts
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = [p.grad for _, p in named]
            if i == 0:
                grad1 = _norms((n, g) for (n, _), g in zip(named, grads) if g is not None)
            adam.step(grads)
        change = _norms((n, p.detach() - start[n]) for n, p in named)
        return losses, grad1, change

    def readings(self):
        """The program's readings of its first steps, as ``reference`` gives
        the reference's."""
        return self.losses, self.grad1, self.change

    @staticmethod
    def compare(got, want) -> Dict[str, float]:
        """Every number the check may compare (the cell's ``limits`` say
        which it does): ``loss_gap``, the first step's relative loss gap;
        ``grad1_gap``, the worst leaf's first-gradient norm gap;
        ``update_gap`` and ``update_median_gap``, the worst and the median
        leaf's gap of the change over the checked steps. Leaves whose
        reference gradient is nought to rounding (under a thousandth of the
        median leaf's: PoseNet's first conv bias, whose one-channel groups
        the group norm removes, and the sparse branch's conv biases, which
        batch norm removes) are left out of every norm gap: their gradient
        and their move are round-off alone."""
        (losses, grad1, change), (ref_losses, ref_grad1, ref_change) = got, want
        moved = yardstick.moved_leaves(ref_grad1)
        whole = len(losses) == len(ref_losses) and bool(grad1)
        inf = float("inf")
        return {
            "loss_gap": yardstick.rel_gap(losses[0], ref_losses[0]) if whole else inf,
            "grad1_gap": yardstick.norm_gap(grad1, ref_grad1, moved) if whole else inf,
            "update_gap": yardstick.norm_gap(change, ref_change, moved),
            "update_median_gap": yardstick.median_norm_gap(change, ref_change, moved),
        }

    # ---- the model FLOPs of a step, counted from the reference ----------------
    def flops_per_step(self) -> float:
        """Convolution and matrix FLOPs of one step of the reference's forward
        and backward at the cell's shapes, counted on the meta device (no
        recomputation; the optimizer's elementwise work not counted)."""
        from torch.utils.flop_counter import FlopCounterMode

        m = self.cfg.model
        nets = ref_steps.build(m.depth_net.name, bool(m.pose_net.get("name"))).to("meta")
        host = self.pool[0]
        batch = {}
        for k, v in host.items():
            if isinstance(v, list):
                batch[k] = [torch.empty(c.shape, device="meta") for c in v]
            else:
                batch[k] = torch.empty(v.shape, device="meta")
        prepared = {"rgb": batch["rgb"], "rgb_original": batch["rgb"],
                    "context": batch.get("rgb_context", []),
                    "context_original": batch.get("rgb_context", [])}
        for k in ("intrinsics", "depth", "input_depth"):
            if k in batch:
                prepared[k] = batch[k]
        with FlopCounterMode(display=False) as counter:
            ref_steps.train_loss(m.name, nets, prepared, False).backward()
        return float(counter.get_total_flops())


def build(config, traffic, cell, seed, device, make_pool, fault=None) -> TrainCell:
    return TrainCell(config, traffic, cell, seed, device, make_pool, fault)

