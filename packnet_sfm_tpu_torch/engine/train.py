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

In one process on a card the train step is captured once as a CUDA graph
and replayed every step (``captures_graph`` says where): the host then
enqueues a step as a few copies and one graph launch, not the thousands of
launches of the eager step.
"""

from __future__ import annotations

import contextlib
import warnings
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
    draw_flip,
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
    [0, 1]. A tensor on ``device`` already (the captured train step's
    inputs) is decoded where it is, with no copy."""
    if isinstance(x, torch.Tensor) and x.device == torch.device(device):
        t = x
    else:
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

    def forward(self, batch: Dict, progress: float, num_scales: Optional[int], generator,
                flip_flag: Optional[torch.Tensor] = None):
        return model_loss(self.model, batch, progress=progress, num_scales=num_scales,
                          generator=generator, band=self.band, flip_flag=flip_flag)


def _space_band(model: SfmModelDef, mesh: Optional[Mesh2D]) -> Optional[spatial.Band]:
    """This rank's band of ``mesh``, with the depth network checked; None
    without a space axis."""
    band = mesh.band() if mesh is not None else None
    if band is not None:
        spatial.network_stride(model.depth_net)
    return band


# the host batch's entries that the train step reads (``prepare_train_batch``)
TRAIN_INPUT_KEYS = ("rgb", "rgb_context", "jitter", "intrinsics", "depth", "input_depth",
                    "pose_context")


def captures_graph(device: torch.device, model: SfmModelDef,
                   optimizer: torch.optim.Optimizer, grad_accum: int = 1,
                   mesh: Optional[Mesh2D] = None, distributed: Optional[bool] = None) -> bool:
    """Whether ``make_train_step`` captures its step as a CUDA graph, from
    what the step can observe: a CUDA device, no process group
    (``distributed``, None: ``torch.distributed.is_initialized()``), no
    (data x space) grid, one microbatch, a kind whose loss trains and does
    not read ``progress`` (NRS's reads it on the host, ``models/sfm.
    SfmModelDef.loss_reads_progress``), and an Adam whose every group is
    ``capturable`` with its rate a tensor (``engine/factory.make_optimizer``
    builds it so on a card). Everything else takes the eager step."""
    if distributed is None:
        distributed = torch.distributed.is_initialized()
    return (torch.device(device).type == "cuda" and not distributed and mesh is None
            and grad_accum <= 1 and model.has_loss and not model.loss_reads_progress
            and isinstance(optimizer, torch.optim.Adam)
            and all(g.get("capturable", False) and isinstance(g["lr"], torch.Tensor)
                    for g in optimizer.param_groups))


def _input_leaves(batch: Dict) -> list:
    """[(key, list index or None, host array)] of the entries of a host batch
    that the train step reads."""
    leaves = []
    for key in TRAIN_INPUT_KEYS:
        value = batch.get(key)
        if isinstance(value, (list, tuple)):
            leaves += [(key, i, np.asarray(a)) for i, a in enumerate(value)]
        elif value is not None:
            leaves.append((key, None, np.asarray(value)))
    return leaves


def _signature(leaves: list) -> tuple:
    return tuple((key, i, a.shape, a.dtype.str) for key, i, a in leaves)


class _StepGraph:
    """The train step captured as one CUDA graph, and its static inputs.

    Built at the first call, before any state moves: the batch goes to
    static device tensors of its host dtypes; the forward and backward run
    once eagerly on a side stream (cuDNN's plans, the kernels' first loads),
    the buffers they move (BatchNorm's statistics) are put back and their
    gradients dropped; Adam's state is made for every parameter that got a
    gradient, as its first step would make it, and a throwaway Adam of the
    same options takes one step so that its kernels are loaded; then
    ``captured`` (decode, jitter, cast, forward, loss, backward) and
    ``optimizer.step()`` are captured. The parameters' gradients are then
    the graph's, Adam's state the tensors it updates. The launches that the
    warm-up and the capture counted are taken back off the kernels' launch
    counters, and each replay adds the captured ones (``engine/spans.
    add_launches``).

    Each replay: the host batch is copied into one of two pinned staging
    sets (the set's last copy to the card waited for first, by an event)
    and from there to the static inputs with ``non_blocking`` copies, which
    leave the launch queue full; the step's flip draw fills a device flag
    that the graph selects the straight or the flipped tensors by
    (``models/sfm._depth_with_flip``); the graph replays; the accumulator
    adds the graph's metric rows.
    """

    STAGES = 2

    def __init__(self, leaves: list, device: torch.device, captured, model: SfmModelDef,
                 optimizer: torch.optim.Optimizer, flips: bool):
        self.signature = _signature(leaves)
        self.device, self.optimizer = device, optimizer
        hosts = [torch.as_tensor(a) for _, _, a in leaves]
        self.inputs = [torch.empty(h.shape, dtype=h.dtype, device=device) for h in hosts]
        self.stages = [[torch.empty(h.shape, dtype=h.dtype, pin_memory=True) for h in hosts]
                       for _ in range(self.STAGES)]
        self.copied = [torch.cuda.Event() for _ in range(self.STAGES)]
        self.turn = 0
        self.flag = torch.zeros((), dtype=torch.bool, device=device) if flips else None
        batch: Dict = {}
        for (key, i, _), t in zip(leaves, self.inputs):
            if i is None:
                batch[key] = t
            else:
                batch.setdefault(key, []).append(t)
        counted = spans.launch_counts()
        with torch.cuda.device(device):
            self._copy_in(leaves)
            self._warm_up(captured, batch, model)
            warmed = spans.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.rows = captured(batch, self.flag)
                with spans.span("optimizer_step"):
                    optimizer.step()
        after = spans.launch_counts()
        self.launches = {k: after[k] - warmed[k] for k in after}
        spans.add_launches({k: counted[k] - after[k] for k in after})
        self.grads = [(p, p.grad) for group in optimizer.param_groups
                      for p in group["params"] if p.grad is not None]
        self.state, self.rates = optimizer.state, [g["lr"] for g in optimizer.param_groups]

    def _warm_up(self, captured, batch: Dict, model: SfmModelDef) -> None:
        buffers = [b.detach().clone() for b in model.buffers()]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            captured(batch, self.flag)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
        optimizer = self.optimizer
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None or optimizer.state.get(p):
                    continue
                state = optimizer.state[p]
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if group.get("amsgrad"):
                    state["max_exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
        optimizer.zero_grad(set_to_none=True)
        options = {k: v for k, v in optimizer.param_groups[0].items()
                   if k not in ("params", "lr", "initial_lr")}
        probe = torch.zeros(1, device=self.device, requires_grad=True)
        probe.grad = torch.ones(1, device=self.device)
        with warnings.catch_warnings():     # that it steps uncaptured
            warnings.simplefilter("ignore")
            type(optimizer)([{"params": [probe], **options,
                              "lr": torch.zeros((), device=self.device)}]).step()

    def takes(self, leaves: list) -> bool:
        """Whether a host batch has the captured shapes and dtypes."""
        return _signature(leaves) == self.signature

    def current(self, optimizer: torch.optim.Optimizer) -> bool:
        """Whether the optimizer still holds the state and the rates that the
        graph reads (``load_state_dict`` replaces them)."""
        return optimizer.state is self.state and all(
            g["lr"] is lr for g, lr in zip(optimizer.param_groups, self.rates))

    def _copy_in(self, leaves: list) -> None:
        stage, copied = self.stages[self.turn], self.copied[self.turn]
        copied.synchronize()        # this set's copy of two steps back has left it
        with spans.span("batch_copy"):
            for (_, _, a), pinned, static in zip(leaves, stage, self.inputs):
                pinned.copy_(torch.as_tensor(a))
                spans.note_copy(pinned)
                static.copy_(pinned, non_blocking=True)
        copied.record(torch.cuda.current_stream(self.device))
        self.turn = (self.turn + 1) % self.STAGES

    def run(self, leaves: list, flip: bool, acc: Dict[str, torch.Tensor]) -> None:
        """One step: the batch in, the flip's flag set, a replay, the metric
        rows added to ``acc``."""
        with torch.cuda.device(self.device):
            self._copy_in(leaves)
            if self.flag is not None:
                self.flag.fill_(flip)
            with spans.span("graph_replay"):
                self.graph.replay()
        spans.note_replay()
        spans.add_launches(self.launches)
        with torch.no_grad():
            for k, row in self.rows.items():
                acc[k] += row

    def restore_grads(self) -> None:
        """Point the parameters' gradients back at the graph's after an eager
        step made its own."""
        for p, g in self.grads:
            p.grad = g


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

    Where ``captures_graph`` holds (one process on a card, no grid, one
    microbatch, a loss that does not read ``progress``, a capturable Adam:
    ``engine/factory.make_optimizer`` on a card), the first call captures
    the step as one CUDA graph (``_StepGraph``) and every call whose batch
    has the captured shapes and dtypes replays it: the same math in the
    same precision, the hand-written kernels' launches recorded in it. The
    flip is still drawn on the host, once a step; the schedule's step runs
    after the replay and fills the rate that the next replay reads. A batch
    of other shapes takes the eager step.
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

    graph: Optional[_StepGraph] = None
    use_graph = captures_graph(device, model, optimizer, grad_accum, mesh)

    def captured(batch: Dict, flip_flag: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's device work on the graph's static inputs, up to the
        backward: the metrics' accumulator rows [value, 1]."""
        batch = prepare_train_batch(batch, device)
        if compute_dtype != torch.float32:
            batch = cast_batch(batch, compute_dtype)
        with spans.span("forward"):
            loss, (metrics, _) = loss_module(batch, 0.0, num_scales, None, flip_flag)
        with spans.span("backward"):
            loss.float().backward()
        one = torch.ones((), device=device)
        return {k: torch.stack([metrics[k].detach().float(), one])
                for k in METRIC_KEYS if k in metrics}

    def step(acc: Dict[str, torch.Tensor], batch: Dict, progress: float = 0.0):
        nonlocal graph
        with spans.step_span("train_step"):
            if use_graph:
                leaves = _input_leaves(batch)
                if graph is not None and not graph.current(optimizer):
                    graph = None        # a state loaded since: capture it anew
                if graph is None:
                    graph = _StepGraph(leaves, device, captured, model, optimizer,
                                       flips=model.flip_lr_prob > 0.0 and generator is not None)
                if graph.takes(leaves):
                    graph.run(leaves, draw_flip(model, generator), acc)
                    if scheduler is not None:
                        scheduler.step()
                    return acc
                eager(acc, batch, progress)
                graph.restore_grads()
                return acc
            return eager(acc, batch, progress)

    def eager(acc: Dict[str, torch.Tensor], batch: Dict, progress: float):
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
