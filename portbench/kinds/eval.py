"""The eval kind: the program's flip-fused eval step
(``engine/train.make_eval_step``) on the configuration's ``eval`` recipe,
and its check against the reference.

Set-up builds the step and runs it once on each of two batches (the
window's only shapes). The window keeps every step's per-sample metric
rows (7 metrics in 4 modes), and the post-processed inverse depth of a
sample of its first steps drawn from the seed. After it, with the
program's state freed, the reference evaluates those steps' pool batches in
float64, and the run compares the sampled steps' answers with it.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import torch

from portbench import weights
from portbench.reference import nets as ref_nets
from portbench.reference import steps as ref_steps

# the sampled steps: SAMPLED_STEPS of the window's first SAMPLED_FROM
SAMPLED_STEPS, SAMPLED_FROM = 4, 8
# the smooth metrics (abs_rel, sqr_rel, rmse, rmse_log) and the shares
# within a ratio (a1, a2, a3) among the 7
SMOOTH, SHARES = slice(0, 4), slice(4, 7)


class EvalCell:
    min_steps = SAMPLED_FROM        # the window's steps the check samples from
    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int, device,
                 make_pool, fault: Optional[str] = None):
        from packnet_sfm_tpu_torch.core.config import config_from_dict
        from packnet_sfm_tpu_torch.engine.factory import setup_metrics_config, setup_model
        from packnet_sfm_tpu_torch.engine.train import make_eval_step

        self.config, self.traffic, self.cell = config, traffic, cell
        self.seed, self.device = seed, device
        self.cfg = config_from_dict(config[cell["recipe"]])
        self.model = setup_model(self.cfg.model, device=device, seed=0)
        weights.load(self.model, seed)
        self._step = make_eval_step(self.model, setup_metrics_config(self.cfg))
        self.pool = make_pool(traffic, seed, device)
        self.fault = fault
        self.keep = set(random.Random(int(seed)).sample(range(SAMPLED_FROM), SAMPLED_STEPS))
        self.rows = []
        for i in range(2):
            self.step(i)
        self.rows = []

    def step(self, i: int) -> None:
        batch = self.pool[i % len(self.pool)]
        if self.fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        out = self._step(batch)
        rows = {m: out[m] for m in ref_steps.EVAL_MODES}
        if len(self.rows) in self.keep:
            rows["inv_depth"] = out["inv_depth"]
        if self.fault == "answer_altered":
            rows["depth"] = rows["depth"] * 1.01
        self.rows.append((i % len(self.pool), rows))

    def images_per_step(self) -> int:
        return self.traffic["batch"]

    def free(self) -> None:
        del self.model, self._step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def picks(self):
        """The window's steps that the check compares, drawn from the seed
        among its first SAMPLED_FROM."""
        picks = sorted(k for k in self.keep if k < len(self.rows))
        if not picks:
            raise RuntimeError(f"the window ran {len(self.rows)} steps, too few to check")
        return picks

    def readings(self):
        """{step: {mode: [B, 7]}} of the program's sampled steps."""
        return {k: self.rows[k][1] for k in self.picks()}

    def reference(self, dtype=torch.float64, cast=None, tf32: bool = False):
        """The reference's answers for the sampled steps' batches, as
        ``readings`` gives the program's, computed in ``dtype`` (the seed's
        float32 weights widened), with ``cast`` on every convolution and
        TF32 as ``tf32`` says."""
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        m = self.cfg.model
        nets = ref_steps.build(m.depth_net.name, bool(m.pose_net.get("name"))).to(self.device)
        weights.load(nets, self.seed)
        nets.to(dtype)
        ref_nets.set_precision(nets, cast)
        by_batch, out = {}, {}
        for k in self.picks():
            idx = self.rows[k][0]
            if idx not in by_batch:
                by_batch[idx] = ref_steps.eval_rows(nets["depth_net"], self.pool[idx],
                                                    self.device, m.params.max_depth, dtype)
            out[k] = by_batch[idx]
        return out

    @staticmethod
    def compare(got, want) -> Dict[str, float]:
        """The compared numbers, over the sampled steps' samples:
        ``metric_gap``, the worst relative gap of the smooth metrics
        (abs_rel, sqr_rel, rmse, rmse_log) in the 4 modes; ``share_gap_px``,
        the worst gap of the shares within a ratio (a1 to a3) in the 4 modes,
        in pixels (the share's gap times the sample's count of valid
        pixels, from the reference); and ``inv_gap``, the worst pixel's
        relative gap of the post-processed inverse depth."""
        gaps = dict.fromkeys(("metric_gap", "share_gap_px", "inv_gap"), 0.0)
        for k, modes in want.items():
            valid = modes["valid_px"].double()[:, None]
            for mode in (*ref_steps.EVAL_MODES, "inv_depth"):
                g = got[k][mode].double() if k in got and mode in got[k] else None
                w = modes[mode].double()
                if g is None or g.shape != w.shape or not torch.isfinite(g).all():
                    return dict.fromkeys(gaps, float("inf"))
                if mode == "inv_depth":
                    rel = (g - w).abs() / w.abs().clamp(min=1e-30)
                    gaps["inv_gap"] = max(gaps["inv_gap"], float(rel.max()))
                    continue
                rel = (g[:, SMOOTH] - w[:, SMOOTH]).abs() / w[:, SMOOTH].abs().clamp(min=1e-30)
                px = (g[:, SHARES] - w[:, SHARES]).abs() * valid
                gaps["metric_gap"] = max(gaps["metric_gap"], float(rel.max()))
                gaps["share_gap_px"] = max(gaps["share_gap_px"], float(px.max()))
        return gaps

    def flops_per_step(self) -> float:
        """Convolution FLOPs of the reference's forward of the 2B straight
        and flipped images at the cell's shapes (meta device)."""
        from torch.utils.flop_counter import FlopCounterMode

        m = self.cfg.model
        net = ref_steps.build(m.depth_net.name, False)["depth_net"].to("meta").eval()
        b, (h, w) = self.traffic["batch"], self.traffic["shape"]
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            net(torch.empty(2 * b, h, w, 3, device="meta"))
        return float(counter.get_total_flops())


def build(config, traffic, cell, seed, device, make_pool, fault=None) -> EvalCell:
    return EvalCell(config, traffic, cell, seed, device, make_pool, fault)


