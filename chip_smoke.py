#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (packnet_sfm_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run:
1. Build every kernel of csrc/ with nvcc for sm_90a, from this checkout.
2. Kernels: K6f/K6b (csrc/softargmax.cu) against their plain PyTorch
   version on seeded inputs at the NRS path's shape, [B,3,192,192], p = 20,
   B = 1 and 2, T = 0.05 and 1e-4, with their times.
3. Slice: the NRS self-supervised train step of configs/train_omnicam.yaml
   (GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet, 384x384, batch 1,
   random weights from seed 0) on synthetic samples: generic_project through
   the kernels against the plain version on the first step's real tensors;
   model_loss on the card against the CPU (plain version) at 96x96; then 5
   train steps at progress 0.5 with the launch counters read around them.

Float32 throughout, TF32 off (the omnicam config's bfloat16 policy is not
ported yet). Needs a CUDA device; exits non-zero, printing no result,
without one. The last line is {"ok": true, "device": {...}}; the line
before it lists each kernel with its launches on the train steps, error
against the plain version, time, plain time and bound.
"""

import json
import statistics
import subprocess
import sys
import time

PATCH = 20
STEPS = 5
PROGRESS = 0.5
# Published H100 SXM peaks at 700 W: FP32 outside the tensor cores, HBM3.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations every window position needs. Forward: 3-term dot (5),
# 1/T scale (1), max and exp(logit - m) (3), s/nx/ny updates (6).
# Backward replay: dot (5), scale (1), exp(logit - m) (2), weight (4); the
# d_dir/d_ray accumulations of non-zero weights are left out (lower bound).
FWD_OPS, BWD_OPS = 15, 12

# Tolerances, kernel vs plain version (coordinates in pixels; gradients
# relative to their largest magnitude). At T = 1e-4, near-tied window
# positions turn the f32 rounding of the logits (summed in a different
# order by the kernel and the plain einsum) into weight changes of ~1e-3
# between positions up to 40 px apart, and the gradients there are the
# largest (p(1-p)/T); d rays is summed with atomics. Measured on an H100:
# T = 1e-4 coordinates within 0.019 px, gradients within 0.97% of the
# largest; T = 0.05 within 6.1e-5 px and 6e-5.
TOL_PX = {0.05: 2e-3, 1e-4: 0.1}
TOL_GRAD = {0.05: 1e-3, 1e-4: 5e-2}
TOL_LOSS_CPU = 1e-3


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def unit(gen, shape, device):
    import torch

    v = torch.randn(shape, generator=gen)
    return (v / v.norm(dim=1, keepdim=True)).to(device)


def omnicam_config():
    from packnet_sfm_tpu_torch.core.config import OMNICAM, config_from_dict, parse_train_config

    return parse_train_config(config_from_dict(OMNICAM))


def kernel_phase(device, shape, path_temperature):
    """K6f/K6b against the plain version at the projection grid of an image
    of ``shape`` (half its size), and their times at B = 1."""
    import torch

    from packnet_sfm_tpu_torch.ops import softargmax as sa

    h, w = shape[0] // 2, shape[1] // 2
    err = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(0)
    for b in (1, 2):
        d, r = unit(gen, (b, 3, h, w), device), unit(gen, (b, 3, h, w), device)
        # a fixed scalar function of (ex, ey): sum(a * ex + c * ey)
        a, c = (torch.randn((b, h, w), generator=gen).to(device) for _ in range(2))
        for temperature in (0.05, 1e-4):
            ex, ey, m, s = sa.softargmax_fwd_cuda(d, r, temperature, PATCH)
            ddir, drays = sa.softargmax_bwd_cuda(d, r, temperature, PATCH, ex, ey, m, s, a, c)
            torch.cuda.synchronize()
            dp, rp = d.clone().requires_grad_(), r.clone().requires_grad_()
            ex_p, ey_p = sa.softargmax_coords_plain(dp, rp, temperature, PATCH)
            ((ex_p * a).sum() + (ey_p * c).sum()).backward()
            e_fwd = max((ex - ex_p).abs().max().item(), (ey - ey_p).abs().max().item())
            e_dir = (ddir - dp.grad).abs().max().item()
            e_ray = (drays - rp.grad).abs().max().item()
            rel = max(e_dir / dp.grad.abs().max().item(), e_ray / rp.grad.abs().max().item())
            log(f"K6f B={b} T={temperature:g}: max |d coords| {e_fwd:.3e} px "
                f"(tolerance {TOL_PX[temperature]:g})")
            log(f"K6b B={b} T={temperature:g}: max |d grad| d_dir {e_dir:.3e} d_rays "
                f"{e_ray:.3e}, {rel:.3e} of the largest (tolerance {TOL_GRAD[temperature]:g})")
            if not (e_fwd <= TOL_PX[temperature] and rel <= TOL_GRAD[temperature]):
                raise AssertionError("kernel disagrees with its plain version")
            if not (torch.isfinite(ddir).all() and torch.isfinite(drays).all()):
                raise AssertionError("non-finite kernel gradient")
            err["fwd"] = max(err["fwd"], e_fwd)
            err["bwd"] = max(err["bwd"], e_ray, e_dir)

    # times at the main path's shape and temperature (B = 1, 192x192)
    gen = torch.Generator().manual_seed(1)
    d, r = unit(gen, (1, 3, h, w), device), unit(gen, (1, 3, h, w), device)
    a, c = (torch.randn((1, h, w), generator=gen).to(device) for _ in range(2))
    t = path_temperature
    ex, ey, m, s = sa.softargmax_fwd_cuda(d, r, t, PATCH)
    k_fwd = time_ms(lambda: sa.softargmax_fwd_cuda(d, r, t, PATCH))
    k_bwd = time_ms(lambda: sa.softargmax_bwd_cuda(d, r, t, PATCH, ex, ey, m, s, a, c))
    with torch.no_grad():
        p_fwd = time_ms(lambda: sa.softargmax_coords_plain(d, r, t, PATCH))
    dp, rp = d.clone().requires_grad_(), r.clone().requires_grad_()
    ex_p, ey_p = sa.softargmax_coords_plain(dp, rp, t, PATCH)
    out = (ex_p * a).sum() + (ey_p * c).sum()
    p_bwd = time_ms(lambda: torch.autograd.grad(out, (dp, rp), retain_graph=True))
    plane = h * w * 4
    positions = h * w * (2 * PATCH + 1) ** 2
    b_fwd = bound_ms((2 * 3 + 4) * plane, FWD_OPS * positions)
    b_bwd = bound_ms((2 * 3 + 6 + 2 * 3) * plane, BWD_OPS * positions)
    log(f"times at [1,3,{h},{w}] T={t:.3e}: K6f {k_fwd:.3f} ms (plain {p_fwd:.3f}, bound "
        f"{b_fwd[0]:.4f}), K6b {k_bwd:.3f} ms (plain backward {p_bwd:.3f}, bound {b_bwd[0]:.4f})")
    return {
        "softargmax_fwd": dict(max_abs_err=err["fwd"], ms=k_fwd, plain_ms=p_fwd,
                               bound_ms=b_fwd[0], bound_by=b_fwd[1]),
        "softargmax_bwd": dict(max_abs_err=err["bwd"], ms=k_bwd, plain_ms=p_bwd,
                               bound_ms=b_bwd[0], bound_by=b_bwd[1]),
    }


def real_tensor_projection(model, batch, device, temperature):
    """generic_project through the kernels vs the plain version on the first
    step's tensors (the model's state is restored afterwards)."""
    import torch

    from packnet_sfm_tpu_torch.engine.train import prepare_train_batch
    from packnet_sfm_tpu_torch.geometry.camera_generic import (
        GenericCamera, canonical_pinhole_rays, generic_project, generic_reconstruct)
    from packnet_sfm_tpu_torch.losses.generic_photometric import blend_ray_surface
    from packnet_sfm_tpu_torch.losses.photometric import inv2depth
    from packnet_sfm_tpu_torch.models.sfm import model_forward

    state = {k: v.clone() for k, v in model.state_dict().items()}
    worst = 0.0
    with torch.no_grad():
        b = prepare_train_batch(batch, device)
        h, w = b["rgb"].shape[1:3]
        out = model_forward(model, b, train=True)
        rays = blend_ray_surface(canonical_pinhole_rays(h, w, device=device),
                                 out["ray_surface"], PROGRESS)
        world = generic_reconstruct(GenericCamera(rays=rays), inv2depth(out["inv_depths"][0]))
        for pose in out["poses"]:
            cam = GenericCamera(rays=rays, Tcw=pose)
            kern = generic_project(cam, world, temperature, patch=PATCH)
            plain = generic_project(cam, world, temperature, patch=PATCH, projector="plain")
            if not torch.isfinite(kern).all():
                raise AssertionError("non-finite projection")
            # normalized coords -> pixels of the 192x192 projection grid
            worst = max(worst, (kern - plain).abs().max().item() * (h // 2 - 1) / 2)
    model.load_state_dict(state)
    log(f"generic_project on the first step's tensors: kernel vs plain max "
        f"{worst:.3e} px of the {h // 2}x{w // 2} grid (tolerance {TOL_PX[1e-4]:g})")
    if worst > TOL_PX[1e-4]:
        raise AssertionError("generic_project through the kernels disagrees with plain")
    return worst


def cpu_reference(model, cfg, device):
    """model_loss at 96x96 on the card (kernels) and on the CPU (plain
    version) with the same weights."""
    import torch

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.engine.train import prepare_train_batch
    from packnet_sfm_tpu_torch.models.sfm import model_loss

    s = SyntheticSfmDataset(length=1, height=96, width=96, seed=7)[0]
    batch = {"rgb": s["rgb"][None], "rgb_context": [c[None] for c in s["rgb_context"]]}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    cpu_model = setup_model(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in state.items()})
    with torch.no_grad():
        gpu_loss = model_loss(model, prepare_train_batch(batch, device), PROGRESS)[0].item()
        cpu_loss = model_loss(cpu_model, prepare_train_batch(batch, "cpu"), PROGRESS)[0].item()
    model.load_state_dict(state)
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    log(f"model_loss 96x96: card {gpu_loss:.7f} cpu {cpu_loss:.7f} rel {rel:.2e} "
        f"(tolerance {TOL_LOSS_CPU:g})")
    if not rel <= TOL_LOSS_CPU:
        raise AssertionError("model_loss on the card disagrees with the CPU")


def slice_phase(device, cfg):
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
    from packnet_sfm_tpu_torch.geometry.camera_generic import projection_temperature
    from packnet_sfm_tpu_torch.ops import softargmax as sa

    H, W = cfg.datasets.augmentation.image_shape
    log(f"config: {cfg.model.name}, {cfg.model.depth_net.name}-{cfg.model.depth_net.version} "
        f"+ {cfg.model.pose_net.name}, {H}x{W}, batch {cfg.datasets.train.batch_size}; "
        f"arch.dtype {cfg.arch.dtype} is not ported yet: this run trains float32")
    temperature = projection_temperature(PROGRESS)
    ds = SyntheticSfmDataset(length=STEPS, height=H, width=W, seed=0)
    batches = []
    for i in range(STEPS):
        s = ds[i]
        batches.append({"rgb": s["rgb"][None], "rgb_context": [c[None] for c in s["rgb_context"]]})

    model = setup_model(cfg.model, device=device, seed=0)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                          steps_per_epoch=len(ds))
    step = make_train_step(model, optimizer, scheduler)
    proj_err = real_tensor_projection(model, batches[0], device, temperature)
    cpu_reference(model, cfg, device)

    acc = zero_metrics(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.reset_launch_counts()
    losses, step_ms, prev = [], [], 0.0
    for b in batches:
        t0 = time.perf_counter()
        acc = step(acc, b, progress=PROGRESS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        cum = acc["loss"][0].item()
        losses.append(cum - prev)
        prev = cum
    counts = dict(sa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log("losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log("step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median of steps 2-{STEPS}: {statistics.median(step_ms[1:]):.2f} ms")
    log(f"peak memory allocated: {peak / 2**20:.1f} MiB; launches: {counts}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    want = {"softargmax_fwd": 2 * STEPS, "softargmax_bwd": 2 * STEPS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts, proj_err


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from packnet_sfm_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_name_and_power())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; TF32 off for "
        "matmuls and cuDNN convolutions")

    t0 = time.perf_counter()
    report = _cuda.build(verbose=True)
    for name, (secs, out) in report.items():
        log(f"built csrc/{name}.cu in {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    log(f"build phase {time.perf_counter() - t0:.1f} s")

    from packnet_sfm_tpu_torch.geometry.camera_generic import projection_temperature

    cfg = omnicam_config()
    measured = kernel_phase(device, cfg.datasets.augmentation.image_shape,
                            projection_temperature(PROGRESS))
    counts, _ = slice_phase(device, cfg)

    meta = {
        "softargmax_fwd": dict(replaces="packnet_sfm_tpu/ops/pallas_softargmax.py:105"),
        "softargmax_bwd": dict(replaces="packnet_sfm_tpu/ops/pallas_softargmax.py:159"),
    }
    kernels = [dict(name=name, route="cuda", source="packnet_sfm_tpu_torch/csrc/softargmax.cu",
                    replaces=meta[name]["replaces"], launches=counts[name],
                    max_abs_err=measured[name]["max_abs_err"], ms=measured[name]["ms"],
                    plain_ms=measured[name]["plain_ms"], bound_ms=measured[name]["bound_ms"],
                    bound_by=measured[name]["bound_by"], library_ms=None)
               for name in ("softargmax_fwd", "softargmax_bwd")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
