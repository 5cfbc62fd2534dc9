"""Where the time of a train or eval step goes on the card.

    python -m packnet_sfm_tpu_torch.tools.profile_step [--config kitti|omnicam|san]
        [--eval] [--dtype config|float32|bfloat16] [--steps 5] [--out FILE]

Builds one of three training configurations as chip_smoke.py does
(synthetic samples, random weights from seed 0, TF32 off for float32 work),
computing in the config's ``arch.dtype`` (bfloat16 for both) unless
``--dtype`` says otherwise; ``--dtype float32`` gives what the profiles
before the bfloat16 policy measured:
- ``kitti``: configs/train_kitti.yaml, SelfSupModel, PackNet01-1A + PoseNet,
  192x640, batch 4, device jitter and the training flip on;
- ``omnicam``: configs/train_omnicam.yaml, GenericSelfSupModel,
  RaySurfaceResNet-18 + PoseNet, 384x384, batch 1, progress 0.5;
- ``san``: configs/train_packnet_san_kitti.yaml, SemiSupCompletionModel,
  PackNetSAN01-1A (no pose net at supervised weight 1), 352x1216, batch 1:
  the rgb and the rgb+d passes, ground truth at SAN_GT_DENSITY and input
  depth at SAN_INPUT_DENSITY of the pixels, the training flip on.
With ``--eval`` (kitti only) it profiles the flip-fused eval step instead:
B = 1, rgb 192x640, ground truth at eigen_test's 375x1242 with 4% of its
pixels valid, the Garg crop, as chip_smoke.py's phase 5; its forward is the
range depth_net and its metric half the range depth_metrics (the resize to
the ground truth, the flip fusion and the 4 modes with their sorts).
Takes 3 warm-up steps, then profiles ``--steps`` steps with
torch.profiler: the wall time per step, the device time per kernel and per
group of kernels, and the device's busy share (summed kernel time over wall
time; one stream, so kernels do not overlap). Convolution kernels are split
into 2D and 3D by the rank of the launching operator's input; the forward
kernels are also summed by the model's profiler ranges (depth_net, pose_net,
photometric_loss: the warp, SSIM and reduction chain of the loss;
supervised_loss; depth_metrics in eval; sparse_branch, PackNet-SAN's lidar
encoder inside depth_net, counted apart from it). The
profiler slows the host, so the wall time and busy share here are those of a
profiled step; chip_smoke.py times the step without it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

# Kernel-name fragments -> group, first match wins. Convolution kernels are
# told apart (2D from 3D) by their operator, not by these names: cuDNN runs
# both through kernels of the same names.
GROUPS = (
    ("softargmax", "softargmax kernels (K6f/K6b)"),
    ("Sort", "sorts (the metrics' medians)"),
    ("sort", "sorts (the metrics' medians)"),
    ("warp_fwd_kernel", "warp kernels (warp_fwd/warp_bwd)"),
    ("warp_bwd_kernel", "warp kernels (warp_fwd/warp_bwd)"),
    ("conv", "conv2d (cuDNN)"),
    ("gemm", "conv2d (cuDNN)"),
    ("sm90_xmma", "conv2d (cuDNN)"),
    ("cudnn", "conv2d (cuDNN)"),
    ("dgrad", "conv2d (cuDNN)"),
    ("wgrad", "conv2d (cuDNN)"),
    ("batch_norm", "batch/group norm"),
    ("group_norm", "batch/group norm"),
    ("GroupNorm", "batch/group norm"),
    ("RowwiseMoments", "batch/group norm"),          # GroupNorm's statistics
    ("ComputeFusedParams", "batch/group norm"),
    ("avg_pool", "SSIM pooling and padding"),
    ("reflection_pad", "SSIM pooling and padding"),
    ("reduce", "reductions"),
    ("index", "gather/index (resize, window gathers)"),
    ("gather", "gather/index (resize, window gathers)"),
    ("scatter", "gather/index (resize, window gathers)"),
    ("adam", "optimizer"),
    ("Adam", "optimizer"),
    ("multi_tensor", "optimizer"),
    ("elementwise", "elementwise"),
    ("vectorized", "elementwise"),
    ("Memset", "memset/copy"),
    ("Memcpy", "memset/copy"),
    ("copy", "memset/copy"),
)
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution_transpose", "aten::_convolution",
            "aten::convolution", "aten::conv2d", "aten::conv3d")
REGIONS = ("depth_net", "sparse_branch", "pose_net", "photometric_loss", "supervised_loss",
           "depth_metrics")
EVAL_GT, EVAL_GT_DENSITY = (375, 1242), 0.04
# PackNet-SAN's train crop (crop_train_borders), and the shares of its
# pixels with ground truth (KITTI's accumulated groundtruth maps) and with
# input depth (one velodyne sweep)
SAN_SHAPE, SAN_GT_DENSITY, SAN_INPUT_DENSITY = (352, 1216), 0.16, 0.04


def group_of(name: str) -> str:
    for fragment, group in GROUPS:
        if fragment in name:
            return group
    return "other"


def _conv_rank(evt):
    """4 or 5 for a convolution operator event (rank of its first input),
    else None."""
    if evt.name not in CONV_OPS:
        return None
    shapes = getattr(evt, "input_shapes", None) or []
    return len(shapes[0]) if shapes and shapes[0] else None


def _region_of(evt):
    while evt is not None:
        if evt.name in REGIONS:
            return evt.name
        evt = evt.cpu_parent
    return None


def build_eval(device, dtype: str):
    """run(i) of the eval step of the KITTI config's model at B = 1 against
    ground truth at 375x1242."""
    from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict, parse_train_config
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import setup_metrics_config, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_eval_step

    cfg = parse_train_config(config_from_dict(KITTI))
    h, w = cfg.datasets.augmentation.image_shape
    rgb = SyntheticSfmDataset(length=1, height=h, width=w, seed=0, back_context=0,
                              forward_context=0)[0]["rgb"]
    gt = SyntheticSfmDataset(length=1, height=EVAL_GT[0], width=EVAL_GT[1], seed=1,
                             depth_density=EVAL_GT_DENSITY, back_context=0,
                             forward_context=0)[0]["depth"]
    batch = {"rgb": rgb[None], "depth": gt[None]}
    step = make_eval_step(setup_model(cfg.model, device=device, seed=0,
                                      dtype=model_dtype(cfg, dtype)),
                          setup_metrics_config(cfg))

    def run(i):
        step(batch)
    return run


def model_dtype(cfg, dtype: str):
    """The compute dtype to build the model with (None: float32)."""
    from packnet_sfm_tpu_torch.engine.factory import compute_dtype

    return {"config": compute_dtype(cfg), "float32": None,
            "bfloat16": torch.bfloat16}[dtype]


def san_batches(n: int, h: int, w: int, bs: int = 1):
    """n host batches of PackNet-SAN's train step: Synthetic rgb [bs, h, w,
    3], its depth at SAN_GT_DENSITY as 'depth' and at SAN_INPUT_DENSITY as
    'input_depth'."""
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset

    ds = SyntheticSfmDataset(length=n * bs, height=h, width=w, seed=0, back_context=0,
                             forward_context=0, depth_density=SAN_GT_DENSITY)
    rng = np.random.default_rng(0)
    batches = []
    for i in range(n):
        samples = [ds[i * bs + j] for j in range(bs)]
        depth = np.stack([s["depth"] for s in samples])
        keep = rng.uniform(size=depth.shape) < SAN_INPUT_DENSITY / SAN_GT_DENSITY
        batches.append({"rgb": np.stack([s["rgb"] for s in samples]), "depth": depth,
                        "input_depth": (depth * keep).astype(np.float32)})
    return batches


def build(config: str, n: int, device, dtype: str):
    """run(i) of train step i of one training configuration."""
    from packnet_sfm_tpu_torch.core.config import (
        KITTI, OMNICAM, SAN_KITTI, config_from_dict, parse_train_config)
    from packnet_sfm_tpu_torch.datasets.augmentations import draw_jitter_params
    from packnet_sfm_tpu_torch.datasets.synthetic import (
        SyntheticSfmDataset, collate_train_batch)
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

    raw = {"kitti": KITTI, "omnicam": OMNICAM, "san": SAN_KITTI}[config]
    cfg = parse_train_config(config_from_dict(raw))
    bs = cfg.datasets.train.batch_size
    if config == "san":
        batches = san_batches(n, *SAN_SHAPE, bs)
    else:
        h, w = cfg.datasets.augmentation.image_shape
        ds = SyntheticSfmDataset(length=n * bs, height=h, width=w, seed=0)
        rng = np.random.default_rng(0)
        batches = []
        for i in range(n):
            samples = [ds[i * bs + j] for j in range(bs)]
            if config == "kitti":
                jitter = [draw_jitter_params(cfg.datasets.augmentation.jittering, rng)
                          for _ in samples]
                batches.append(collate_train_batch(samples, jitter))
            else:
                batch = collate_train_batch(samples)
                del batch["intrinsics"]
                batches.append(batch)
    dt = model_dtype(cfg, dtype)
    model = setup_model(cfg.model, device=device, seed=0, dtype=dt)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, n)
    step = make_train_step(model, optimizer, scheduler,
                           generator=torch.Generator().manual_seed(0),
                           compute_dtype=dt or torch.float32)
    progress = 0.5 if config == "omnicam" else 0.0
    acc = zero_metrics(device)

    def run(i):
        step(acc, batches[i], progress=progress)
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("kitti", "omnicam", "san"), default="omnicam")
    ap.add_argument("--eval", action="store_true", help="profile the eval step (kitti)")
    ap.add_argument("--dtype", choices=("config", "float32", "bfloat16"), default="config",
                    help="compute dtype: the config's arch.dtype, or this one")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="", help="write the JSON summary here too")
    args = ap.parse_args()
    if args.eval and args.config != "kitti":
        ap.error("--eval profiles the kitti config's eval step")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    run = (build_eval(device, args.dtype) if args.eval
           else build(args.config, args.steps + 3, device, args.dtype))
    for i in range(3):
        run(i)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for i in range(3, 3 + args.steps):
            t0 = time.perf_counter()
            run(i)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

    # Device-side events, less the ranges that annotations (such as the
    # optimizer's "Optimizer.step#Adam.step" or the model's ranges) leave on
    # the device timeline around the kernels they contain. ("#" alone is no
    # test: kernel symbols carry it in lambda names.)
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.") and e.name not in REGIONS]
    steps = len(wall)
    per_kernel = defaultdict(float)
    for evt in kernels:
        per_kernel[evt.name] += evt.device_time_total / 1e3  # us -> ms
    device_ms = sum(per_kernel.values()) / steps

    # Kernels by the operator that launched them: convolutions by rank, the
    # rest by kernel name; forward kernels by the model's range.
    groups, regions, attributed = defaultdict(float), defaultdict(float), 0.0
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        rank = _conv_rank(evt)
        region = _region_of(evt)
        for k in evt.kernels:
            ms = k.duration / 1e3 / steps
            attributed += ms
            if rank in (4, 5) and "elementwise" not in k.name and "Memset" not in k.name:
                groups["conv3d (cuDNN)" if rank == 5 else "conv2d (cuDNN)"] += ms
            else:
                groups[group_of(k.name)] += ms
            if region is not None:
                regions[region] += ms
    if attributed < 0.9 * device_ms:
        raise RuntimeError(f"the profiler linked only {attributed:.2f} of {device_ms:.2f} ms "
                           "of kernels per step to operators: the groups would mislead")

    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:30]
    summary = {
        "config": args.config + (" eval" if args.eval else "") + f" ({args.dtype} dtype)",
        "device": torch.cuda.get_device_name(0),
        "steps": steps,
        "wall_ms_per_step": wall,
        "wall_ms_median": statistics.median(wall),
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / statistics.median(wall),
        "attributed_to_operators_ms_per_step": attributed,
        "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "forward_regions_ms_per_step": dict(regions),
        "top_kernels_ms_per_step": {k[:120]: v / steps for k, v in top},
        "kernel_launches_per_step": len(kernels) / steps,
        "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
    }
    print(f"{summary['config']}: wall ms/step {summary['wall_ms_median']:.2f} (median of {steps}), "
          f"device ms/step {device_ms:.2f}, busy share {summary['busy_share']:.3f}, "
          f"device kernels/step {summary['kernel_launches_per_step']:.0f}, "
          f"{attributed:.2f} ms/step linked to operators")
    for name, ms in summary["groups_ms_per_step"].items():
        print(f"  {ms:8.3f} ms  {name}")
    print("forward kernels by range (ms/step):")
    for name, ms in summary["forward_regions_ms_per_step"].items():
        print(f"  {ms:8.3f} ms  {name}")
    print("top kernels (ms/step):")
    for name, ms in summary["top_kernels_ms_per_step"].items():
        print(f"  {ms:8.3f}  {name}")
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
