"""Where the time of the NRS train step goes on the card.

    python -m packnet_sfm_tpu_torch.tools.profile_step [--steps 5] [--out FILE]

Builds the omnicam configuration (configs/train_omnicam.yaml: RaySurfaceResNet-18
+ PoseNet, 384x384, batch 1, float32, TF32 off) as chip_smoke.py does, takes
3 warm-up steps, then profiles ``--steps`` train steps with torch.profiler:
the wall time per step, the device time per kernel and per group of kernels,
and the device's busy share (summed kernel time over wall time; one stream,
so kernels do not overlap). The profiler slows the host, so the wall time
and busy share here are those of a profiled step; chip_smoke.py times the
step without it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch

# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("softargmax", "softargmax kernels (K6f/K6b)"),
    ("grid_sampler", "grid_sample"),
    ("conv", "convolution (cuDNN)"),
    ("gemm", "convolution (cuDNN)"),
    ("sm90_xmma", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("dgrad", "convolution (cuDNN)"),
    ("wgrad", "convolution (cuDNN)"),
    ("batch_norm", "batch/group norm"),
    ("group_norm", "batch/group norm"),
    ("GroupNorm", "batch/group norm"),
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


def group_of(name: str) -> str:
    for fragment, group in GROUPS:
        if fragment in name:
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="", help="write the JSON summary here too")
    args = ap.parse_args()

    from packnet_sfm_tpu_torch.core.config import OMNICAM, config_from_dict, parse_train_config
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cfg = parse_train_config(config_from_dict(OMNICAM))
    h, w = cfg.datasets.augmentation.image_shape
    n = args.steps + 3
    ds = SyntheticSfmDataset(length=n, height=h, width=w, seed=0)
    batches = [{"rgb": s["rgb"][None], "rgb_context": [c[None] for c in s["rgb_context"]]}
               for s in (ds[i] for i in range(n))]
    model = setup_model(cfg.model, device=device, seed=0)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, n)
    step = make_train_step(model, optimizer, scheduler)
    acc = zero_metrics(device)
    for b in batches[:3]:
        acc = step(acc, b, progress=0.5)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches[3:]:
            t0 = time.perf_counter()
            acc = step(acc, b, progress=0.5)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

    # Device-side events, less the ranges that annotations (such as the
    # optimizer's "Optimizer.step#Adam.step") leave on the device timeline
    # around the kernels they contain. ("#" alone is no test: kernel symbols
    # carry it in lambda names.)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    per_kernel = defaultdict(float)
    for evt in kernels:
        per_kernel[evt.name] += evt.device_time_total / 1e3  # us -> ms
    steps = len(wall)
    device_ms = sum(per_kernel.values()) / steps
    groups = defaultdict(float)
    for name, ms in per_kernel.items():
        groups[group_of(name)] += ms / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:20]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "steps": steps,
        "wall_ms_per_step": wall,
        "wall_ms_median": statistics.median(wall),
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / statistics.median(wall),
        "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": {k[:120]: v / steps for k, v in top},
        "kernel_launches_per_step": len(kernels) / steps,
    }
    print(f"wall ms/step {summary['wall_ms_median']:.2f} (median of {steps}), device ms/step "
          f"{device_ms:.2f}, busy share {summary['busy_share']:.3f}, "
          f"device kernels/step {summary['kernel_launches_per_step']:.0f}")
    for name, ms in summary["groups_ms_per_step"].items():
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
