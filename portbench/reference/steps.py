"""The reference's train and eval steps: the losses of the two model kinds
that the benchmark trains, a plain Adam, and the flip-fused depth
evaluation with its 7 metrics in 4 modes. Plain PyTorch in the dtype it is
given (float64 for the check's truth); imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.losses import (
    jitter,
    pose_vec_to_mat,
    resize,
    self_supervised_loss,
    sparse_l1,
    to_float,
)
from portbench.reference.nets import PackNet, PackNetSAN, PoseNet

METRIC_NAMES = ("abs_rel", "sqr_rel", "rmse", "rmse_log", "a1", "a2", "a3")
EVAL_MODES = ("depth", "depth_pp", "depth_gt", "depth_pp_gt")


def build(depth_net: str, pose: bool) -> torch.nn.ModuleDict:
    """The reference networks of a configuration, named as the program's
    ``SfmModelDef`` names them ('depth_net', 'pose_net'), so that both
    draw the same weights (``portbench/weights.py``)."""
    nets = torch.nn.ModuleDict({"depth_net": {"PackNet01": lambda: PackNet(),
                                              "PackNetSlim01": lambda: PackNet(slim=True),
                                              "PackNetSAN01": PackNetSAN}[depth_net]()})
    if pose:
        nets["pose_net"] = PoseNet()
    return nets


def prepare(batch: Dict, device, batch_dtype=None, dtype=torch.float32) -> Dict:
    """The host batch on the device in ``dtype``: images in [0, 1] (jittered
    copies for the networks where the batch has jitter factors), depths and
    intrinsics; the networks' inputs rounded to ``batch_dtype`` where the
    configuration casts its batch but computes in float32."""
    out = {"rgb_original": to_float(batch["rgb"], device, dtype)}
    out["context_original"] = [to_float(c, device, dtype) for c in batch.get("rgb_context", [])]
    params = to_float(batch["jitter"], device, dtype) if "jitter" in batch else None
    out["rgb"] = jitter(out["rgb_original"], params) if params is not None else out["rgb_original"]
    out["context"] = [jitter(c, params) if params is not None else c
                      for c in out["context_original"]]
    for key in ("intrinsics", "depth", "input_depth"):
        if key in batch:
            out[key] = to_float(batch[key], device, dtype)
    if batch_dtype is not None:
        for key in ("rgb", "input_depth"):
            if key in out:
                out[key] = out[key].to(batch_dtype).to(dtype)
    return out


def train_loss(kind: str, nets: Dict, batch: Dict, flip: bool) -> torch.Tensor:
    """The training loss of ``kind`` on a prepared batch; ``flip``: the
    depth network sees its inputs flipped left to right and its inverse
    depths are flipped back."""
    net = nets["depth_net"]
    fl = (lambda t: t.flip(2)) if flip else (lambda t: t)
    if kind == "SelfSupModel":
        inv = [fl(d) for d in net(fl(batch["rgb"]))]
        vec = nets["pose_net"](batch["rgb"], batch["context"])
        poses = [pose_vec_to_mat(vec[:, i]) for i in range(vec.shape[1])]
        return self_supervised_loss(batch["rgb_original"], batch["context_original"], inv,
                                    batch["intrinsics"], poses)
    if kind == "SemiSupCompletionModel":       # supervised weight 1: no photometric term
        out = net(fl(batch["rgb"]), fl(batch["input_depth"]))
        loss = sparse_l1([fl(d) for d in out["inv_depths"]], batch["depth"])
        loss = loss + sparse_l1([fl(d) for d in out["inv_depths_rgbd"]], batch["depth"])
        return loss + out["depth_loss"]
    raise ValueError(f"the reference has no loss for {kind}")


class Adam:
    """Adam (beta 0.9 / 0.999, eps 1e-8, no weight decay), written out."""

    def __init__(self, params: List[torch.Tensor], lrs: List[float]):
        self.params, self.lrs, self.t = params, lrs, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v, lr in zip(self.params, grads, self.m, self.v, self.lrs):
            if g is None:
                continue
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + 1e-8))


# ---- eval ------------------------------------------------------------------

def garg_mask(h: int, w: int, device, dtype) -> torch.Tensor:
    m = torch.zeros(h, w, device=device, dtype=dtype)
    m[int(0.40810811 * h):int(0.99189189 * h), int(0.03594771 * w):int(0.96405229 * w)] = 1.0
    return m


def _lower_median(values, valid):
    """Element (n - 1) // 2 of each row's sorted valid entries."""
    vals = torch.sort(torch.where(valid > 0, values, torch.full_like(values, float("inf"))), -1).values
    idx = ((valid.sum(-1).long() - 1) // 2).clamp(min=0)
    return vals.gather(-1, idx[:, None])[:, 0]


def depth_metrics(gt, pred, max_depth: float, gt_scale: bool):
    """[B, 7] metrics of depth ``pred`` [B, h, w, 1] against ``gt`` [B, H,
    W, 1]: pred resized bilinearly to gt, the Garg crop, 0 < gt < max_depth."""
    b, h, w, _ = gt.shape
    pred = resize(pred, (h, w))
    g, p = gt.reshape(b, -1), pred.reshape(b, -1)
    valid = ((g > 0) & (g < max_depth)).to(g.dtype) * garg_mask(h, w, g.device, g.dtype).reshape(1, -1)
    n = valid.sum(-1).clamp(min=1.0)
    if gt_scale:
        p = p * (_lower_median(g, valid) / _lower_median(p, valid).clamp(min=1e-6))[:, None]
    p = p.clamp(0.0, max_depth)
    g = torch.where(valid > 0, g, torch.ones_like(g))
    p = torch.where(valid > 0, p, torch.ones_like(p))
    thresh = torch.maximum(g / p, p / g)
    diff = (g - p) * valid
    rows = [(diff.abs() / g).sum(-1) / n, (diff ** 2 / g).sum(-1) / n,
            torch.sqrt((diff ** 2).sum(-1) / n),
            torch.sqrt((((g.log() - p.log()) * valid) ** 2).sum(-1) / n)]
    rows += [((thresh < 1.25 ** k) * valid).sum(-1) / n for k in (1, 2, 3)]
    return torch.stack(rows, 1)


def valid_pixels(gt, max_depth: float):
    """[B] the pixels that ``depth_metrics`` counts in each sample of
    ``gt`` [B, H, W, 1]: the Garg crop, 0 < gt < max_depth."""
    b, h, w, _ = gt.shape
    g = gt.reshape(b, -1)
    return (((g > 0) & (g < max_depth)).to(g.dtype)
            * garg_mask(h, w, g.device, g.dtype).reshape(1, -1)).sum(-1)


def post_process(inv, inv_flipped):
    """The flip fusion: each border ramp from its own pass, the mean between."""
    w = inv.shape[2]
    hat = inv_flipped.flip(2)
    xs = torch.linspace(0.0, 1.0, w, device=inv.device, dtype=inv.dtype).view(1, 1, w, 1)
    mask = 1.0 - (20.0 * (xs - 0.05)).clamp(0.0, 1.0)
    mask_hat = mask.flip(2)
    return mask_hat * inv + mask * hat + (1.0 - mask - mask_hat) * 0.5 * (inv + hat)


@torch.no_grad()
def eval_rows(net, batch: Dict, device, max_depth: float,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The flip-fused eval step of a host batch, in ``dtype``: {mode: [B,
    7]}, 'inv_depth', the post-processed inverse depth [B, H, W, 1], and
    'valid_px', each sample's count of pixels the metrics cover [B]."""
    rgb = to_float(batch["rgb"], device, dtype)
    gt = to_float(batch["depth"], device, dtype)
    b = rgb.shape[0]
    net.eval()
    inv2 = net(torch.cat([rgb, rgb.flip(2)]))[0]
    inv, inv_pp = inv2[:b], post_process(inv2[:b], inv2[b:])
    depth, depth_pp = 1.0 / inv.clamp(min=1e-6), 1.0 / inv_pp.clamp(min=1e-6)
    return {"depth": depth_metrics(gt, depth, max_depth, False),
            "depth_pp": depth_metrics(gt, depth_pp, max_depth, False),
            "depth_gt": depth_metrics(gt, depth, max_depth, True),
            "depth_pp_gt": depth_metrics(gt, depth_pp, max_depth, True),
            "inv_depth": inv_pp, "valid_px": valid_pixels(gt, max_depth)}

