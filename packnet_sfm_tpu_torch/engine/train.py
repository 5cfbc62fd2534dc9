"""Train and eval steps (port of ``packnet_sfm_tpu/engine/train.py``).

``make_train_step`` returns a step doing forward, backward, the Adam update,
the learning-rate schedule and the BatchNorm running-statistics update, and
adding the step's metrics to a device-side accumulator {key: [sum, count]}
that the caller reads once per epoch. ``make_eval_step`` returns the flip-
fused depth evaluation of a batch: one forward of the straight and flipped
images, the flip post-process and the 7 metrics in 4 modes, per sample.

The bfloat16 policy (``arch.dtype``) is the JAX package's: the networks
compute in the dtype they were built with (``engine/factory.setup_model``),
parameters, gradients and Adam's moments stay float32, and the train step
casts the prepared batch's network inputs (the images and 'input_depth')
to the compute dtype and the loss back to float32; the targets ('depth',
'pose_context') and the intrinsics stay float32 (``cast_batch``). The eval
step casts nothing: the model casts inside.

On a (data x space) grid (``parallel/mesh.make_mesh_2d``, passed as
``mesh``) each rank gets its data rank's whole samples, and the depth
network runs on the rank's band of their rows (``parallel/spatial.py``):
the train step's loss and gradient are the whole batch's, the eval step
gathers the bands of the inverse depth before the metrics.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from packnet_sfm_tpu_torch.engine import spans
from packnet_sfm_tpu_torch.engine.metrics import (
    DepthMetricsConfig,
    compute_depth_metrics_per_sample,
    post_process_inv_depth,
)
from packnet_sfm_tpu_torch.models.sfm import (
    DEPTH_SCALES,
    SfmModelDef,
    check_band,
    model_forward,
    model_loss,
    scales_used,
)
from packnet_sfm_tpu_torch.ops.image import flip_lr
from packnet_sfm_tpu_torch.ops.jitter import apply_jitter
from packnet_sfm_tpu_torch.parallel import spatial
from packnet_sfm_tpu_torch.parallel.mesh import Mesh2D, gather_rows

METRIC_KEYS = ("loss", "photometric_loss", "smoothness_loss",
               "supervised_loss", "supervised_loss_rgbd", "depth_loss",
               "velocity_loss")


def zero_metrics(device) -> Dict[str, torch.Tensor]:
    """Device-side metric accumulator: {key: [sum, count]}."""
    return {k: torch.zeros(2, dtype=torch.float32, device=device) for k in METRIC_KEYS}


def to_device_float(x, device) -> torch.Tensor:
    """A host array as a float32 tensor on ``device``; uint8 is scaled to
    [0, 1]."""
    host = torch.as_tensor(np.asarray(x))
    spans.note_copy(host)
    t = host.to(device, non_blocking=True)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()


def prepare_train_batch(batch: Dict, device) -> Dict:
    """Device half of the input pipeline: move a host batch (numpy, NHWC) to
    ``device``, decode uint8 and apply the device jitter.

    uint8 images are scaled to [0, 1] in float32. With a 'jitter' key
    ([B, 4] factors, ``ops/jitter.apply_jitter``) the networks see the
    jittered 'rgb' and 'rgb_context' while 'rgb_original' and
    'rgb_context_original' keep the plain images for the loss; without it
    the originals alias the images. 'intrinsics' goes along as float32.
    The copies run inside the span 'batch_copy' (``engine/spans.py``),
    twice a step: the images' before the jitter, the rest's after it.
    """
    def to_f(x):
        return to_device_float(x, device)

    with spans.span("batch_copy"):
        rgb = to_f(batch["rgb"])
        ctx = [to_f(c) for c in batch.get("rgb_context", [])]
        params = to_f(batch["jitter"]) if batch.get("jitter") is not None else None
    out = {"rgb": rgb, "rgb_original": rgb}
    if ctx:
        out["rgb_context"] = out["rgb_context_original"] = ctx
    if params is not None:
        out["rgb"] = apply_jitter(rgb, params)
        if ctx:
            out["rgb_context"] = [apply_jitter(c, params) for c in ctx]
    with spans.span("batch_copy"):
        for key in ("intrinsics", "depth", "input_depth"):
            if key in batch:
                out[key] = to_f(batch[key])
        if "pose_context" in batch:
            out["pose_context"] = [to_f(p) for p in batch["pose_context"]]
    return out


def _microbatches(batch: Dict, grad_accum: int):
    """Split every leaf of a prepared batch into ``grad_accum`` equal parts
    along the batch axis."""
    b = batch["rgb"].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} does not split into {grad_accum} microbatches")
    m = b // grad_accum
    for g in range(grad_accum):
        part = slice(g * m, (g + 1) * m)
        yield {k: [t[part] for t in v] if isinstance(v, list) else v[part]
               for k, v in batch.items()}


# what cast_batch leaves in float32: the intrinsics (ROADMAP.md §3 (h)) and
# the targets of the supervised and velocity losses (§3 (l))
FLOAT32_KEYS = ("intrinsics", "depth", "pose_context")


def cast_batch(batch: Dict, dtype) -> Dict:
    """The prepared batch with its floating network inputs cast to
    ``dtype``: the images and 'input_depth'.

    The JAX package casts every floating leaf. That rounds the intrinsics,
    fx = 721.5377 to 720 in bfloat16 (``ROADMAP.md`` §3 (h)), and the
    targets: ground-truth depth to 0.25 m between 32 and 64 m, 0.5 m beyond
    (§3 (l)), and the OXTS translations of 'pose_context'. The port keeps
    ``FLOAT32_KEYS`` in float32. An image that two keys share (the
    originals without jitter) is cast once and stays shared."""
    done: Dict[int, torch.Tensor] = {}

    def cast(t):
        if t.is_floating_point() and id(t) not in done:
            done[id(t)] = t.to(dtype)
        return done.get(id(t), t)

    return {k: v if k in FLOAT32_KEYS else
            [cast(t) for t in v] if isinstance(v, list) else cast(v)
            for k, v in batch.items()}


class _LossModule(torch.nn.Module):
    """``model_loss`` as a module's forward (on this rank's band, if any),
    so that the forward that ``DistributedDataParallel`` wraps is the one
    whose graph backward walks."""

    def __init__(self, model: SfmModelDef, band: Optional[spatial.Band] = None):
        super().__init__()
        self.model = model
        self.band = band

    def forward(self, batch: Dict, progress: float, num_scales: Optional[int], generator):
        return model_loss(self.model, batch, progress=progress, num_scales=num_scales,
                          generator=generator, band=self.band)


def _space_band(model: SfmModelDef, mesh: Optional[Mesh2D]) -> Optional[spatial.Band]:
    """This rank's band of ``mesh``, with the depth network checked; None
    without a space axis."""
    band = mesh.band() if mesh is not None else None
    if band is not None:
        spatial.network_stride(model.depth_net)
    return band


def make_train_step(model: SfmModelDef, optimizer: torch.optim.Optimizer, scheduler=None,
                    num_scales: Optional[int] = None, grad_accum: int = 1,
                    generator: Optional[torch.Generator] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    mesh: Optional[Mesh2D] = None):
    """Returns step(acc, batch, progress) -> acc.

    ``batch`` is a host batch (see ``prepare_train_batch``); ``progress``
    is the Python float fraction of training done. ``num_scales`` overrides
    the photometric scale count. ``grad_accum`` > 1 splits the batch into
    microbatches whose gradients and metrics are averaged before the one
    optimizer step. ``generator`` (a CPU ``torch.Generator``) draws the
    training flip of ``SelfSupModel``; without it there is no flip.
    ``compute_dtype`` other than float32 casts the prepared batch's images
    to it (``cast_batch``); the model must have been built with it. The
    loss is float32 either way.

    In a process group (``parallel/mesh.init_distributed``, even of one
    rank) each rank steps on its own rows of the global batch and the
    gradient is the global batch's mean: ``DistributedDataParallel``
    averages it across the ranks after the last microbatch (``no_sync`` on
    the others), with the buffers left alone (the BatchNorm statistics are
    global already, so every rank moves them alike) and unused parameters
    looked for only where the loss reads fewer scales than the depth
    network makes (their gradient stays None, as on one rank). The flip's
    generator, seeded alike on every rank, gives every rank the same draw.
    A kind without a loss (``SfmModel``, ``GenericSfmModel``) takes no
    backward, so it is refused there: DDP would wait for a reduction that
    never comes.

    ``mesh``, a (data x space) grid (``parallel/mesh.make_mesh_2d``): each
    rank takes its data rank's whole samples (jittered alike on every rank
    of the space group) and runs the depth network on its band of their
    rows (PackNet's pack convolutions take the two-step path there,
    ``ops/fold_conv.fused_pack_conv``). Each rank's loss is its band's
    share of its data rank's loss; its backward, scaled by the space count,
    gives DDP's average over every rank (over ``mesh.grad_group``) the mean
    over the data ranks of the whole samples' gradient. On the grid the
    gradients are views of DDP's buckets (no second copy of them at the
    resolutions the grid is for). The metrics are the shares summed over
    the space group: every rank of it reports its data rank's loss. The
    grid trains ``SelfSupModel``, ``SemiSupModel``, ``VelSupModel`` and
    ``GenericSelfSupModel``; another kind, a depth network without a band
    path, or a height that does not split into bands of a multiple of the
    depth network's stride raises ``ValueError`` on every rank, before the
    step's first collective (``models/sfm.check_band``).
    """
    device = next(model.parameters()).device
    band = mesh.band() if mesh is not None else None
    if band is not None:        # the kind and the depth network, before any collective
        check_band(model, None, band)
    loss_module = _LossModule(model, band)
    distributed = torch.distributed.is_initialized()
    if distributed and not model.has_loss:
        raise ValueError(f"{model.kind} has no loss to train: train it in one process, "
                         "without a process group")
    if distributed:
        loss_module = DistributedDataParallel(
            loss_module, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False,
            find_unused_parameters=scales_used(model, num_scales) < DEPTH_SCALES,
            process_group=mesh.grad_group if mesh is not None else None,
            gradient_as_bucket_view=mesh is not None)
    # each rank's loss is its band's share: DDP's mean over every rank of the
    # shares' gradients, times the bands, is the data ranks' mean
    scale = band.count if band is not None else 1

    def step(acc: Dict[str, torch.Tensor], batch: Dict, progress: float = 0.0):
        with spans.step_span("train_step"):
            batch = prepare_train_batch(batch, device)
            if compute_dtype != torch.float32:
                batch = cast_batch(batch, compute_dtype)
            optimizer.zero_grad(set_to_none=True)
            totals: Dict[str, torch.Tensor] = {}
            parts = [batch] if grad_accum <= 1 else list(_microbatches(batch, grad_accum))
            for i, part in enumerate(parts):
                # the ranks average their gradients once, after the last microbatch
                defer = distributed and i < len(parts) - 1
                with loss_module.no_sync() if defer else contextlib.nullcontext():
                    with spans.span("forward"):
                        loss, (metrics, _) = loss_module(part, progress, num_scales, generator)
                    if model.has_loss:      # the kinds without a loss have nothing to step
                        with spans.span("backward"):
                            (loss.float() * scale / max(grad_accum, 1)).backward()
                for k, v in spatial.sum_over(metrics, band).items():
                    totals[k] = totals.get(k, 0.0) + v.detach().float() / max(grad_accum, 1)
            with spans.span("optimizer_step"):
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
            with torch.no_grad():
                for k in METRIC_KEYS:
                    if k in totals:
                        acc[k] += torch.stack([totals[k], torch.ones((), device=device)])
            return acc

    return step


EVAL_MODES = ("depth", "depth_pp", "depth_gt", "depth_pp_gt")


def eval_forward(model: SfmModelDef, rgb: torch.Tensor,
                 band: Optional[spatial.Band] = None, **inputs) -> torch.Tensor:
    """Inverse depth of the straight and the flipped inputs, [2B, H, W, 1]:
    one batched depth forward of cat([x, flip_lr(x)]) for the image and for
    every other input of the depth network given in ``inputs`` (PackNet-
    SAN's 'input_depth'), in eval mode (BatchNorm normalizes with its
    running statistics). On a ``band``, the band's rows of it."""
    both = {k: torch.cat([v, flip_lr(v)], dim=0) for k, v in dict(inputs, rgb=rgb).items()}
    with torch.inference_mode():
        out = model_forward(model, both, train=False, band=band)
    return out["inv_depths"][0].float()


def eval_metrics(inv2: torch.Tensor, gt: torch.Tensor,
                 metrics_cfg: DepthMetricsConfig) -> Dict[str, torch.Tensor]:
    """The metric half of the eval step, from ``eval_forward``'s [2B, H, W, 1]
    and the ground truth [B, Hg, Wg, 1]: {mode: [B, 7] per-sample rows} for
    the four ``EVAL_MODES`` ('_pp' post-processed by the flip, '_gt' scaled
    by the ground truth's median), and 'inv_depth', the post-processed
    inverse depth [B, H, W, 1]."""
    with torch.inference_mode(), spans.span("depth_metrics"):
        b = gt.shape[0]
        inv_depth = inv2[:b]
        inv_depth_pp = post_process_inv_depth(inv_depth, inv2[b:])
        depth = 1.0 / torch.clamp(inv_depth, min=1e-6)
        depth_pp = 1.0 / torch.clamp(inv_depth_pp, min=1e-6)
        pm = compute_depth_metrics_per_sample
        return {
            "depth": pm(gt, depth, metrics_cfg, use_gt_scale=False),
            "depth_pp": pm(gt, depth_pp, metrics_cfg, use_gt_scale=False),
            "depth_gt": pm(gt, depth, metrics_cfg, use_gt_scale=True),
            "depth_pp_gt": pm(gt, depth_pp, metrics_cfg, use_gt_scale=True),
            "inv_depth": inv_depth_pp,
        }


def make_eval_step(model: SfmModelDef, metrics_cfg: DepthMetricsConfig,
                   mesh: Optional[Mesh2D] = None):
    """Returns step(batch) -> {mode: [B, 7] per-sample metric rows, and
    'inv_depth'} (see ``eval_metrics``), on the model's device, float32.

    ``batch`` is a host batch (numpy, NHWC): 'rgb' [B, H, W, 3], the
    depth network's other inputs where the batch has them ('input_depth'
    [B, H, W, 1] for PackNet-SAN: its rgb+d rows, else its rgb rows), and
    'depth' [B, Hg, Wg, 1], the ground truth at its own resolution; the
    prediction is brought to it as ``metrics_cfg.scale_output`` says.
    Per-sample rows, not batch means, so that the caller can mask pad rows
    and scatter rows by dataset index.

    On a (data x space) ``mesh`` every rank of a space group takes its data
    rank's whole samples, runs the depth forward on its band of rows and
    gathers the bands (``parallel/mesh.gather_rows``) before the metrics:
    every rank of the group returns the same rows, its data rank's, which a
    caller reducing across ranks counts once (from ``space_index`` 0).
    """
    device = next(model.parameters()).device
    extra_keys = [k for k in model.input_keys if k not in ("rgb", "intrinsics")]
    band = _space_band(model, mesh)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        if band is not None:
            spatial.check_rows(np.shape(batch["rgb"])[1], band.count,
                               spatial.network_stride(model.depth_net))
        with spans.step_span("eval_step"):
            with spans.span("batch_copy"):
                rgb = to_device_float(batch["rgb"], device)
                gt = to_device_float(batch["depth"], device)
                inputs = {k: to_device_float(batch[k], device) for k in extra_keys if k in batch}
            inv2 = gather_rows(eval_forward(model, rgb, band=band, **inputs), mesh)
            return eval_metrics(inv2, gt, metrics_cfg)

    return step
