#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (packnet_sfm_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run:
1. Build every kernel of csrc/ with nvcc for sm_90a, from this checkout.
2. Kernels: K6f/K6b (csrc/softargmax.cu) against their plain PyTorch
   version on seeded inputs at the NRS path's shape, [B,3,192,192], p = 20,
   B = 1 and 2, T = 0.05 and 1e-4, with their times at the path's
   temperature and at T = 0.05, where no window position is skipped; K6b
   run twice on the same inputs must return the same bits; warp_fwd/warp_bwd
   (csrc/warp.cu) against theirs on coordinates that leave the image on
   every side, exact integer coordinates and -1/+1, both padding modes,
   B = 1, 3 and 8, C = 3, 1 and 4, with d image on, and their times at the four
   shapes of the flagship loss beside F.grid_sample's.
3. NRS slice: the self-supervised train step of configs/train_omnicam.yaml
   (GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet, 384x384, batch 1,
   random weights from seed 0) on synthetic samples: generic_project through
   the kernels against the plain version on the first step's real tensors,
   and K6f/K6b timed on those; model_loss on the card against the CPU
   (plain version) at 96x96; then 5
   train steps at progress 0.5 with the launch counters read around them.
4. Flagship slice: the train step of configs/train_kitti.yaml (SelfSupModel,
   PackNet01-1A + PoseNet, 192x640, batch 4, 4 scales, automask, device
   jitter, the training flip; random weights from seed 0) on synthetic
   samples with intrinsics: view_synthesis through the warp kernels against
   the plain version on the first step's real depths and poses; model_loss
   on the card against the CPU at 64x96; then 5 train steps with the launch
   counters read around them.
5. Eval and infer on the flagship model (configs/eval_kitti.yaml's: the
   KITTI config's PackNet01-1A at full width, the Garg crop; random weights
   from seed 0): the flip-fused eval step at 192x640 against ground truth at
   eigen_test's 375x1242 with 4% of its pixels valid, as velodyne gives,
   timed over 10 steps at B = 1 and B = 4, its metric half alone; the step
   on the card against the CPU at 64x96 (gt 75x124); the eval protocol end
   to end (save_checkpoint, then cli.eval.evaluate on a 13-sample Synthetic
   test split in batches of 4, the last one padded) against an every-sample
   oracle; infer's depth-only forward against the eval step's straight
   half. No kernel of the port is on this path: the launch counters must
   read 0 around it.
6. Training loop, from OVERFIT_PACKNET_SYNTHETIC (configs/
   overfit_packnet_synthetic.yaml: SelfSupModel, PackNetSlim01-1A + PoseNet
   at the config's width, lr 5e-5, batch 8, 64x96 Synthetic with device
   jitter and the training flip). Cut so that the phase fits: 2 epochs in
   place of 8 and repeat [2] in place of [24] (8 steps an epoch), every
   checkpoint kept, under build/chip_smoke_train/. ``cli.train``'s
   build_trainer and fit train it: finite losses and a metric table each
   epoch, checkpoints named epoch=NN_depth_gt_abs_rel=V.ckpt, the warp
   launch counters read around the run (4 of each a step); its first two
   steps against the same two steps on the CPU from the same weights
   (losses, and the direction of the weights' update); ``cli.train.train``
   on the epoch-0 checkpoint against the uninterrupted run's epoch 1 (its
   loss, its weights held to epoch 1's own movement, step, learning rates,
   flip generator); a preemption flagged after step 1 writes
   preempt_epoch=00.ckpt, whose resume redoes epoch 0; then the train
   loader alone over an epoch, and the bare step on its batches.

Float32 throughout, TF32 off (the configs' bfloat16 policy is not ported
yet). Needs a CUDA device; exits non-zero, printing no result, without one.
The last line is {"ok": true, "device": {...}}; before the kernels' line,
one line {"eval": {...}} holds phase 5's numbers and one line
{"train": {...}} phase 6's. The line before the last
lists
each kernel with its launches on its train path's steps, error against the
plain version, time, plain time, bound and, where one PyTorch call computes
the same function, that call's time. A bound is the largest of the bytes'
time, the operations' time and the time of an empty kernel's launch,
measured here.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
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
# What K6f cannot go below even where every weight underflows and no
# exponential is taken: dot (5), scale and compare (2) per position.
FWD_FLOOR_OPS = 7
# One exponential per window position on the special-function units: 16
# lanes per clock on each of the 132 SMs, at the card's largest SM clock.
SM_COUNT, SFU_LANES = 132, 16
DENSE_T = 0.05          # no window position of unit vectors is skipped
# the plain soft-argmax takes 5-20 ms a call: fewer of them give its time
PLAIN_REPS = dict(reps=5, rounds=3, warmup=1)

# Tolerances, kernel vs plain version (coordinates in pixels; gradients
# relative to their largest magnitude). At T = 1e-4, near-tied window
# positions turn the f32 rounding of the logits (summed in a different
# order by the kernel and the plain einsum) into weight changes of ~1e-3
# between positions up to 40 px apart, and the gradients there are the
# largest (p(1-p)/T). Measured on an H100: T = 1e-4 coordinates within
# 0.019 px, gradients within 5.8e-4 of the largest; T = 0.05 within
# 7.6e-5 px and 6.0e-5. The gradients' sums have one fixed order.
TOL_PX = {0.05: 2e-3, 1e-4: 0.1}
TOL_GRAD = {0.05: 3e-4, 1e-4: 5e-3}
TOL_LOSS_CPU = 1e-3
# Warp kernels vs plain version: image values in [0, 1). The forward differs
# only by the rounding of fused multiply-adds (measured 1.2e-7). Gradients
# are held relative to their largest magnitude: d coords sums C products per
# pixel in another order (measured 2e-7); d image is summed with atomics, in
# an order that changes from run to run (measured 3e-6).
TOL_WARP_FWD = 1e-5
TOL_WARP_GRAD = 1e-4
# FP32 operations per output pixel of the warp, for the bound: coordinates
# and weights ~20, then 8 (forward) or 16 (backward) per channel.
WARP_OPS = {"fwd": (20, 8), "bwd": (24, 16)}
KITTI_SCALES = 4
# Phase 5: eigen_test's native ground-truth resolution, the share of its
# pixels that velodyne depth covers, and the eval protocol's split.
EVAL_GT = (375, 1242)
EVAL_GT_DENSITY = 0.04
EVAL_STEPS = 10
PROTOCOL_SAMPLES, PROTOCOL_BATCH = 13, 4
# Card against CPU: continuous metrics relative; a1-a3 within 2 / n_valid
# (a pixel whose ratio sits on a threshold may flip). The protocol against
# its every-sample oracle: absolute, as tests/test_eval_protocol.py. Infer
# against the eval step's straight half: relative to the largest inverse
# depth (B = 1 against B = 2 of the same image; cuDNN may pick another
# algorithm for another batch).
TOL_EVAL_CPU = 1e-3
TOL_PROTOCOL = 2e-4
TOL_INFER = 1e-5
# Phase 6: the recipe's cut, and its tolerances. The card's first two train
# steps against the CPU's: losses within TOL_LOSS_CPU, relative, and the
# cosine of the two weight updates at least TOL_UPDATE_COS, as
# tests/test_torch_cuda.py holds them. The resumed run's epoch 1 against the
# uninterrupted one's: the loss within TOL_RESUME_LOSS, relative, and the
# weights' difference, as a norm, within TOL_RESUME of how far epoch 1 moved
# them. They may part at all only because cuDNN sums weight gradients in an
# order that may change between runs; Adam moves a weight by about the rate
# (5e-5) a step whatever the gradient's size, so a resume that lost Adam's
# moments or the step would part by a large share of the movement.
TRAIN_EPOCHS, TRAIN_REPEAT, TRAIN_SCALES = 2, 2, 4
TOL_UPDATE_COS = 0.99
TOL_RESUME_LOSS = 1e-4
TOL_RESUME = 0.05
BARE_STEPS = 6


def log(msg):
    print(msg, flush=True)


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_blocker = []


def time_ms(fn, reps=20, rounds=5, warmup=3):
    """Device time of one ``fn()``, in ms: the median over ``rounds`` of a
    CUDA-event timing of ``reps`` calls enqueued back to back, divided by
    ``reps``. Before each round a large matrix product (~25 ms) keeps the
    card busy while the host enqueues the calls, so that the time between
    the events is the device's and not the host's launch overhead (which is
    several times a small kernel's own time). The inputs are the same in
    every call, so they are read from a warm L2 where they fit."""
    import torch

    if not _blocker:
        _blocker.append(torch.empty((8192, 8192), device="cuda").normal_())
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.mm(_blocker[0], _blocker[0])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


_launch_floor_ms = []


def measure_launch_floor(device):
    """Device time of a kernel that does nothing: no launch goes under it."""
    from packnet_sfm_tpu_torch.ops import _cuda

    _launch_floor_ms[:] = [time_ms(lambda: _cuda.launch_floor(device))]
    log(f"launch floor: an empty kernel takes {_launch_floor_ms[0]:.4f} ms")


def bound_ms(n_bytes, n_ops, other=None):
    """The least time for the work, in ms, and what decides it: the bytes at
    the memory rate, the operations at the FP32 peak, ``other`` (a named time
    of another unit, in ms) or the launch floor measured in this run."""
    times = {"bytes": n_bytes / PEAK_BYTES * 1e3, "operations": n_ops / PEAK_FP32_OPS * 1e3,
             "launch": _launch_floor_ms[0]}
    if other is not None:
        times["operations"] = max(times["operations"], other)
    by = max(times, key=times.get)
    return times[by], by


def unit(gen, shape, device):
    import torch

    v = torch.randn(shape, generator=gen)
    return (v / v.norm(dim=1, keepdim=True)).to(device)


def softargmax_tile_rows(constant="SA_R"):
    """Rows of K6f's (``SA_R``) or K6b's (``SB_R``) 32-wide tile, as
    csrc/softargmax.cu sets them."""
    import re

    from packnet_sfm_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / "softargmax.cu").read_text()
    return int(re.search(rf"constexpr int {constant} = (\d+);", src).group(1))


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
    t = path_temperature
    path_case = time_softargmax(d, r, t, f"seeded unit vectors, T={t:.3e}")
    dense = time_softargmax(d, r, DENSE_T, f"seeded unit vectors, T={DENSE_T:g} (nothing skipped)")
    fwd, bwd = path_case["fwd"], path_case["bwd"]
    return {
        "softargmax_fwd": dict(max_abs_err=err["fwd"], by_case=[fwd, dense["fwd"]],
                               **{k: fwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}),
        "softargmax_bwd": dict(max_abs_err=err["bwd"], by_case=[bwd, dense["bwd"]],
                               **{k: bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}),
    }


def time_softargmax(d, r, t, case):
    """Device times of K6f and K6b and of their plain versions on direction
    and ray fields [1,3,h,w] at temperature ``t``, with their bounds. K6b is
    run twice on the same inputs and must return the same bits, and is held
    against the plain backward on these inputs."""
    import torch

    from packnet_sfm_tpu_torch.ops import softargmax as sa

    _, _, h, w = d.shape
    gen = torch.Generator().manual_seed(3)
    a, c = (torch.randn((1, h, w), generator=gen).to(d.device) for _ in range(2))
    plane = h * w * 4
    positions = h * w * (2 * PATCH + 1) ** 2
    exp_ms = positions / (SM_COUNT * SFU_LANES * max_sm_clock_hz()) * 1e3
    b_fwd = bound_ms((2 * 3 + 4) * plane, FWD_OPS * positions, other=exp_ms)
    fwd = dict(case=case, ms=time_ms(lambda: sa.softargmax_fwd_cuda(d, r, t, PATCH)),
               bound_ms=b_fwd[0], bound_by=b_fwd[1],
               fp32_bound_ms=FWD_OPS * positions / PEAK_FP32_OPS * 1e3, exp_bound_ms=exp_ms,
               floor_ms=FWD_FLOOR_OPS * positions / PEAK_FP32_OPS * 1e3)
    with torch.no_grad():
        fwd["plain_ms"] = time_ms(lambda: sa.softargmax_coords_plain(d, r, t, PATCH), **PLAIN_REPS)
    ex, ey, m, s = sa.softargmax_fwd_cuda(d, r, t, PATCH)

    def backward():
        return sa.softargmax_bwd_cuda(d, r, t, PATCH, ex, ey, m, s, a, c)

    first = [g.clone() for g in backward()]
    if not all(torch.equal(g1, g2) for g1, g2 in zip(first, backward())):
        raise AssertionError(f"K6b returned other bits on a second call ({case})")
    b_bwd = bound_ms((2 * 3 + 6 + 2 * 3) * plane, BWD_OPS * positions)
    bwd = dict(case=case, ms=time_ms(backward), bound_ms=b_bwd[0], bound_by=b_bwd[1],
               bit_equal_twice=True)
    dp, rp = d.clone().requires_grad_(), r.clone().requires_grad_()
    ex_p, ey_p = sa.softargmax_coords_plain(dp, rp, t, PATCH)
    loss = (ex_p * a).sum() + (ey_p * c).sum()
    plain = torch.autograd.grad(loss, (dp, rp), retain_graph=True)
    tol = TOL_GRAD[DENSE_T if t >= 1e-2 else 1e-4]
    bwd["max_abs_err"] = max((g - q).abs().max().item() for g, q in zip(first, plain))
    bwd["rel_err"] = max(((g - q).abs().max() / q.abs().max()).item() for g, q in zip(first, plain))
    if not (bwd["rel_err"] <= tol and all(torch.isfinite(g).all() for g in first)):
        raise AssertionError(f"K6b disagrees with the plain backward by {bwd['rel_err']:.3e} of "
                             f"the largest gradient, tolerance {tol:g} ({case})")
    bwd["plain_ms"] = time_ms(lambda: torch.autograd.grad(loss, (dp, rp), retain_graph=True),
                              **PLAIN_REPS)
    log(f"K6f at [1,3,{h},{w}] {case}: {fwd['ms']:.4f} ms (bound {b_fwd[0]:.4f}: FP32 "
        f"{fwd['fp32_bound_ms']:.4f}, exponentials {exp_ms:.4f}; floor without exponentials "
        f"{fwd['floor_ms']:.4f}; plain {fwd['plain_ms']:.3f}); K6b {bwd['ms']:.4f} ms, two calls "
        f"bit-equal, within {bwd['rel_err']:.3e} of the plain backward's largest gradient "
        f"(tolerance {tol:g}; bound {b_bwd[0]:.4f}; plain backward {bwd['plain_ms']:.3f})")
    return {"fwd": fwd, "bwd": bwd}


def real_tensor_projection(model, batch, device, temperature):
    """generic_project through the kernels vs the plain version on the first
    step's tensors (the model's state is restored afterwards). Returns the
    worst difference and the direction and ray fields that the first
    projection handed to the kernels."""
    import torch

    from packnet_sfm_tpu_torch.engine.train import prepare_train_batch
    from packnet_sfm_tpu_torch.geometry import camera_generic
    from packnet_sfm_tpu_torch.geometry.camera_generic import (
        GenericCamera, canonical_pinhole_rays, generic_project, generic_reconstruct)
    from packnet_sfm_tpu_torch.losses.generic_photometric import blend_ray_surface
    from packnet_sfm_tpu_torch.losses.photometric import inv2depth
    from packnet_sfm_tpu_torch.models.sfm import model_forward

    state = {k: v.clone() for k, v in model.state_dict().items()}
    worst = 0.0
    operands = []
    entry = camera_generic.softargmax_coords

    def recording(direction, rays, temperature, patch):
        operands.append((direction, rays))
        return entry(direction, rays, temperature, patch)

    camera_generic.softargmax_coords = recording
    try:
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
    finally:
        camera_generic.softargmax_coords = entry
    model.load_state_dict(state)
    log(f"generic_project on the first step's tensors: kernel vs plain max "
        f"{worst:.3e} px of the {h // 2}x{w // 2} grid (tolerance {TOL_PX[1e-4]:g})")
    if worst > TOL_PX[1e-4]:
        raise AssertionError("generic_project through the kernels disagrees with plain")
    return worst, operands[0]


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
    import torch

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
    from packnet_sfm_tpu_torch.geometry.camera_generic import projection_temperature

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
    proj_err, (direction, rays) = real_tensor_projection(model, batches[0], device, temperature)
    real = time_softargmax(direction, rays, temperature,
                           f"the first step's direction and ray fields, T={temperature:.3e}")
    del direction, rays
    _blocker.clear()                # the timing's 256 MiB matrix: not a part of the steps' memory
    torch.cuda.empty_cache()
    cpu_reference(model, cfg, device)

    acc = zero_metrics(device)
    counts = run_steps(step, acc, batches, PROGRESS)
    # two contexts at one scale: one projection and one warp each, per step
    want = {"softargmax_fwd": 2 * STEPS, "softargmax_bwd": 2 * STEPS,
            "warp_fwd": 2 * STEPS, "warp_bwd": 2 * STEPS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts, real


def run_steps(step, acc, batches, progress):
    """Drive the train steps with every launch counter set to 0 just before
    and read just after; returns the counts."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.ops import softargmax as sa
    from packnet_sfm_tpu_torch.ops import warp

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.reset_launch_counts()
    warp.reset_launch_counts()
    losses, step_ms, prev = [], [], 0.0
    for b in batches:
        t0 = time.perf_counter()
        acc = step(acc, b, progress=progress)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        cum = acc["loss"][0].item()
        losses.append(cum - prev)
        prev = cum
    counts = {**sa.launch_counts, **warp.launch_counts}
    peak = torch.cuda.max_memory_allocated()
    log("losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log("step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median of steps 2-{len(batches)}: {statistics.median(step_ms[1:]):.2f} ms")
    log(f"peak memory allocated: {peak / 2**20:.1f} MiB; launches: {counts}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return counts


def kitti_config():
    from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict, parse_train_config

    return parse_train_config(config_from_dict(KITTI))


def path_shapes(cfg):
    """[(B, Hs, Ws)] of the flagship loss's warps: the contexts stacked on
    the batch, at each of the scales."""
    h, w = cfg.datasets.augmentation.image_shape
    b = 2 * cfg.datasets.train.batch_size
    return [(b, h >> i, w >> i) for i in range(KITTI_SCALES)]


def warp_inputs(gen, b, h, w, c, ho, wo, device, spread):
    """Image, coordinates and cotangent. ``spread`` > 1 sends coordinates
    out of the image on every side; the first pixels of the first row are
    exact integer positions, the corners -1/+1 and far-away points."""
    import torch

    image = torch.rand((b, h, w, c), generator=gen)
    coords = (torch.rand((b, ho, wo, 2), generator=gen) * 2 - 1) * spread
    special = torch.tensor([[-1., -1.], [1., 1.], [-1., 1.], [1., -1.], [0., 0.],
                            [2. * 3 / (w - 1) - 1, 2. * 2 / (h - 1) - 1],
                            [5., 5.], [-5., 0.], [0.5, -7.]])
    n = min(len(special), wo)
    coords[0, 0, :n] = special[:n]
    grad = torch.randn((b, ho, wo, c), generator=gen)
    return image.to(device), coords.to(device), grad.to(device)


def smooth_coords(gen, b, h, w, device):
    """Coordinates like a view-synthesis warp's: the identity grid plus a
    shift of a few pixels, leaving the image at its edges."""
    import torch

    ys = torch.linspace(-1, 1, h)[None, :, None].expand(b, h, w)
    xs = torch.linspace(-1, 1, w)[None, None, :].expand(b, h, w)
    shift = (torch.rand((b, 1, 1, 2), generator=gen) - 0.5) * 0.1
    return (torch.stack([xs, ys], dim=-1) + shift).contiguous().to(device)


def warp_kernel_phase(device, shapes):
    """warp_fwd/warp_bwd against the plain version, then their times at the
    flagship loss's shapes beside the plain version's and F.grid_sample's."""
    import torch
    import torch.nn.functional as F

    from packnet_sfm_tpu_torch.ops import warp

    err = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(0)
    cases = [(b, 48, 160, c, ho, wo, pad)
             for b in (1, 8) for c in (3, 1) for (ho, wo) in ((48, 160), (37, 75))
             for pad in ("zeros", "border")]
    # an odd pixel count (no block's output is 16-byte aligned) and the
    # general channel loop
    cases += [(3, 33, 71, 3, 37, 75, "zeros"), (3, 33, 71, 4, 37, 75, "border")]
    cases.append(shapes[0] + (3,) + shapes[0][1:] + ("zeros",))
    for b, h, w, c, ho, wo, pad in cases:
        image, coords, grad = warp_inputs(gen, b, h, w, c, ho, wo, device, spread=1.3)
        out = warp.warp_fwd_cuda(image, coords, pad)
        d_image, d_coords = warp.warp_bwd_cuda(image, coords, grad, pad, need_image_grad=True)
        _, d_coords_only = warp.warp_bwd_cuda(image, coords, grad, pad)
        torch.cuda.synchronize()
        ip, cp = image.clone().requires_grad_(), coords.clone().requires_grad_()
        out_p = warp.grid_sample_plain(ip, cp, pad)
        (out_p * grad).sum().backward()
        e_fwd = (out - out_p).abs().max().item()
        e_dc = (d_coords - cp.grad).abs().max().item()
        e_di = (d_image - ip.grad).abs().max().item()
        rel = max(e_dc / cp.grad.abs().max().item(), e_di / ip.grad.abs().max().item())
        log(f"warp B={b} {h}x{w}x{c} -> {ho}x{wo} {pad}: max |d out| {e_fwd:.3e} (tolerance "
            f"{TOL_WARP_FWD:g}); max |d grad| d_coords {e_dc:.3e} d_image {e_di:.3e}, "
            f"{rel:.3e} of the largest (tolerance {TOL_WARP_GRAD:g})")
        if not (e_fwd <= TOL_WARP_FWD and rel <= TOL_WARP_GRAD
                and torch.equal(d_coords, d_coords_only)):
            raise AssertionError("warp kernel disagrees with its plain version")
        if not (torch.isfinite(out).all() and torch.isfinite(d_coords).all()
                and torch.isfinite(d_image).all()):
            raise AssertionError("non-finite warp kernel output")
        err["fwd"] = max(err["fwd"], e_fwd)
        err["bwd"] = max(err["bwd"], e_dc, e_di)

    # times at the main path's shapes: zeros padding, C = 3, image and output
    # of one size, the image is data (no d image)
    gen = torch.Generator().manual_seed(1)
    rows = {"fwd": [], "bwd": []}
    for b, h, w in shapes:
        image = torch.rand((b, h, w, 3), generator=gen).to(device)
        coords = smooth_coords(gen, b, h, w, device)
        grad = torch.randn((b, h, w, 3), generator=gen).to(device)
        nchw = image.permute(0, 3, 1, 2)

        def library(c):
            return F.grid_sample(nchw, c, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        k_fwd = time_ms(lambda: warp.warp_fwd_cuda(image, coords))
        k_bwd = time_ms(lambda: warp.warp_bwd_cuda(image, coords, grad))
        with torch.no_grad():
            p_fwd = time_ms(lambda: warp.grid_sample_plain(image, coords))
            l_fwd = time_ms(lambda: library(coords))
        cp = coords.clone().requires_grad_()
        out_p = (warp.grid_sample_plain(image, cp) * grad).sum()
        p_bwd = time_ms(lambda: torch.autograd.grad(out_p, cp, retain_graph=True))
        cl = coords.clone().requires_grad_()
        out_l = (library(cl) * grad.permute(0, 3, 1, 2)).sum()
        l_bwd = time_ms(lambda: torch.autograd.grad(out_l, cl, retain_graph=True))
        px = b * h * w
        # forward: coords 8 B, image 12 B, output 12 B per pixel; the
        # backward reads the cotangent (12 B) and writes d coords (8 B) too
        bounds = {"fwd": bound_ms(px * (8 + 12 + 12), px * (WARP_OPS["fwd"][0] + 3 * WARP_OPS["fwd"][1])),
                  "bwd": bound_ms(px * (8 + 12 + 12 + 8), px * (WARP_OPS["bwd"][0] + 3 * WARP_OPS["bwd"][1]))}
        for key, k, pl, lib in (("fwd", k_fwd, p_fwd, l_fwd), ("bwd", k_bwd, p_bwd, l_bwd)):
            rows[key].append(dict(shape=[b, h, w, 3], ms=k, plain_ms=pl,
                                  bound_ms=bounds[key][0], bound_by=bounds[key][1],
                                  library_ms=lib))
            log(f"warp_{key} at [{b},{h},{w},3]: kernel {k:.4f} ms, plain {pl:.3f}, "
                f"F.grid_sample {lib:.4f}, bound {bounds[key][0]:.4f} ({bounds[key][1]})")
    # the line's headline numbers are those of the finest scale; the other
    # three scales go along under by_shape
    return {f"warp_{key}": dict(max_abs_err=err[key], by_shape=rows[key],
                                **{k: v for k, v in rows[key][0].items() if k != "shape"})
            for key in ("fwd", "bwd")}


def flagship_view_synthesis(model, batch, device):
    """view_synthesis through the warp kernels vs the plain version, value
    and d coords, on the first step's real depths and poses at every scale
    (the model's state is untouched: GroupNorm keeps no statistics)."""
    import torch

    from packnet_sfm_tpu_torch.engine.train import prepare_train_batch
    from packnet_sfm_tpu_torch.geometry.camera import (
        Camera, project, reconstruct, scale_intrinsics)
    from packnet_sfm_tpu_torch.losses.photometric import inv2depth
    from packnet_sfm_tpu_torch.models.sfm import model_forward
    from packnet_sfm_tpu_torch.ops import warp
    from packnet_sfm_tpu_torch.ops.image import interpolate_image

    worst_out, worst_rel = 0.0, 0.0
    b = prepare_train_batch(batch, device)
    with torch.no_grad():
        out = model_forward(model, b, train=True)
    full_w = b["rgb"].shape[2]
    gen = torch.Generator().manual_seed(2)
    for inv_depth in out["inv_depths"]:
        hs, ws = inv_depth.shape[1:3]
        K = scale_intrinsics(b["intrinsics"], ws / float(full_w))
        for ref, pose in zip(b["rgb_context_original"], out["poses"]):
            ref_s = interpolate_image(ref, (hs, ws))
            world = reconstruct(Camera(K=K), inv2depth(inv_depth))
            coords = project(Camera(K=K, Tcw=pose), world)
            grad = torch.randn(ref_s.shape, generator=gen).to(device)
            ck, cp = coords.clone().requires_grad_(), coords.clone().requires_grad_()
            kern = warp.grid_sample(ref_s, ck)
            plain = warp.grid_sample_plain(ref_s, cp)
            (kern * grad).sum().backward()
            (plain * grad).sum().backward()
            if not (torch.isfinite(kern).all() and torch.isfinite(ck.grad).all()):
                raise AssertionError("non-finite view synthesis")
            worst_out = max(worst_out, (kern - plain).abs().max().item())
            worst_rel = max(worst_rel, (ck.grad - cp.grad).abs().max().item()
                            / cp.grad.abs().max().item())
    log(f"view_synthesis on the first step's depths and poses, 4 scales x 2 contexts: kernel "
        f"vs plain max |d out| {worst_out:.3e} (tolerance {TOL_WARP_FWD:g}), d coords "
        f"{worst_rel:.3e} of the largest (tolerance {TOL_WARP_GRAD:g})")
    if not (worst_out <= TOL_WARP_FWD and worst_rel <= TOL_WARP_GRAD):
        raise AssertionError("view_synthesis through the kernels disagrees with plain")


def flagship_cpu_reference(model, cfg, device):
    """model_loss at 64x96, batch 2, on the card (kernels) and on the CPU
    (plain version) with the same weights, jitter and flip draw."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.datasets.augmentations import draw_jitter_params
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset, collate_train_batch
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.engine.train import prepare_train_batch
    from packnet_sfm_tpu_torch.models.sfm import model_loss

    ds = SyntheticSfmDataset(length=2, height=64, width=96, seed=7)
    rng = np.random.default_rng(7)
    jitter = [draw_jitter_params(cfg.datasets.augmentation.jittering, rng) for _ in range(2)]
    batch = collate_train_batch([ds[0], ds[1]], jitter)
    cpu_model = setup_model(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    losses = {}
    for name, m, dev in (("card", model, device), ("cpu", cpu_model, "cpu")):
        gen = torch.Generator().manual_seed(0)      # first draw 0.4963 < 0.5: flipped
        with torch.no_grad():
            losses[name] = model_loss(m, prepare_train_batch(batch, dev), generator=gen)[0].item()
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"model_loss 64x96 batch 2, flipped: card {losses['card']:.7f} cpu {losses['cpu']:.7f} "
        f"rel {rel:.2e} (tolerance {TOL_LOSS_CPU:g})")
    if not rel <= TOL_LOSS_CPU:
        raise AssertionError("model_loss on the card disagrees with the CPU")


def flagship_phase(device, cfg):
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.datasets.augmentations import draw_jitter_params
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset, collate_train_batch
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

    H, W = cfg.datasets.augmentation.image_shape
    bs = cfg.datasets.train.batch_size
    loss = cfg.model.loss
    log(f"config: {cfg.model.name}, {cfg.model.depth_net.name}-{cfg.model.depth_net.version} "
        f"+ {cfg.model.pose_net.name}, {H}x{W}, batch {bs}, {loss.num_scales} scales, "
        f"automask {loss.automask_loss}, reduce {loss.photometric_reduce_op}, flip_lr_prob "
        f"{loss.flip_lr_prob}, jitter {tuple(cfg.datasets.augmentation.jittering)}; arch.dtype "
        f"{cfg.arch.dtype} is not ported yet: this run trains float32")
    ds = SyntheticSfmDataset(length=STEPS * bs, height=H, width=W, seed=0)
    rng = np.random.default_rng(0)
    batches = []
    for i in range(STEPS):
        samples = [ds[i * bs + j] for j in range(bs)]
        jitter = [draw_jitter_params(cfg.datasets.augmentation.jittering, rng) for _ in samples]
        batches.append(collate_train_batch(samples, jitter))

    t0 = time.perf_counter()
    model = setup_model(cfg.model, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model built in {time.perf_counter() - t0:.1f} s, {n_params / 1e6:.1f} M parameters")
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                          steps_per_epoch=STEPS)
    step = make_train_step(model, optimizer, scheduler, num_scales=loss.num_scales,
                           generator=torch.Generator().manual_seed(0))
    flagship_view_synthesis(model, batches[0], device)
    flagship_cpu_reference(model, cfg, device)

    counts = run_steps(step, zero_metrics(device), batches, 0.0)
    # the contexts are stacked on the batch: one warp per scale and step
    want = {"softargmax_fwd": 0, "softargmax_bwd": 0,
            "warp_fwd": KITTI_SCALES * STEPS, "warp_bwd": KITTI_SCALES * STEPS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts


def eval_config(kitti):
    """configs/eval_kitti.yaml's run on the card: the KITTI config's model in
    float32 (that file's dtype), its test split replaced by Synthetic
    samples at the eval shape (13 in batches of 4) whose depths are written
    as npz only, and no validation split."""
    cfg = kitti.clone()
    cfg.arch.dtype = "float32"
    cfg.datasets.validation.dataset = []
    h, w = cfg.datasets.augmentation.image_shape
    test = cfg.datasets.test
    test.dataset, test.path, test.split, test.depth_type = ["Synthetic"], [""], [""], [""]
    test.batch_size = PROTOCOL_BATCH
    test.synthetic_length, test.synthetic_height, test.synthetic_width = PROTOCOL_SAMPLES, h, w
    out = ROOT / "build" / "chip_smoke_eval"
    cfg.save.folder = str(out / "save")
    cfg.save.depth = {"rgb": False, "viz": False, "npz": True, "png": False}
    return cfg, out


def eval_batches(cfg, b, gt_hw, seed=0):
    """Host batch of ``b`` Synthetic images at the config's shape, with ground
    truth of another size at velodyne's density."""
    import numpy as np

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset

    h, w = cfg.datasets.augmentation.image_shape
    rgb = SyntheticSfmDataset(length=b, height=h, width=w, seed=seed, back_context=0,
                              forward_context=0)
    gt = SyntheticSfmDataset(length=b, height=gt_hw[0], width=gt_hw[1], seed=seed + 1,
                             depth_density=EVAL_GT_DENSITY, back_context=0, forward_context=0)
    return {"rgb": np.stack([rgb[i]["rgb"] for i in range(b)]),
            "depth": np.stack([gt[i]["depth"] for i in range(b)])}


def time_eval_steps(step, batch):
    """Median wall ms of the eval steps after the first (each ends in a
    synchronize), images/s and the peak memory; checks the rows."""
    import numpy as np
    import torch

    b = batch["rgb"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(EVAL_STEPS + 1):
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    med = statistics.median(ms[1:])
    for mode in ("depth", "depth_pp", "depth_gt", "depth_pp_gt"):
        rows = out[mode].cpu().numpy()
        if rows.shape != (b, 7) or not np.all(np.isfinite(rows)):
            raise AssertionError(f"eval rows of {mode}: {rows}")
    log(f"eval step B={b}, rgb {tuple(batch['rgb'].shape[1:3])}, gt "
        f"{tuple(batch['depth'].shape[1:3])}: " + ", ".join(f"{x:.2f}" for x in ms)
        + f" ms; median of steps 2-{len(ms)}: {med:.2f} ms, {b / med * 1e3:.2f} images/s, "
        f"peak memory allocated {peak:.1f} MiB")
    return dict(step_ms=med, images_per_s=b / med * 1e3, peak_mib=peak)


def eval_cpu_reference(model, cfg, metrics_cfg, device):
    """The eval step on the card and on the CPU with the same weights, at
    64x96 against ground truth at 75x124 (B = 2)."""
    import numpy as np

    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.engine.metrics import garg_crop_mask
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, make_eval_step

    small = cfg.clone()
    small.datasets.augmentation.image_shape = (64, 96)
    batch = eval_batches(small, 2, (75, 124), seed=7)
    cpu_model = setup_model(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    card = make_eval_step(model, metrics_cfg)(batch)
    cpu = make_eval_step(cpu_model, metrics_cfg)(batch)
    valid = ((batch["depth"][..., 0] > 0) & (batch["depth"][..., 0] < metrics_cfg.max_depth)
             & (garg_crop_mask(75, 124).numpy() > 0))
    n_valid = int(valid.reshape(2, -1).sum(axis=1).min())
    worst_rel, worst_a = 0.0, 0.0
    for mode in EVAL_MODES:
        got, want = card[mode].cpu().numpy(), cpu[mode].numpy()
        worst_rel = max(worst_rel, float((np.abs(got[:, :4] - want[:, :4])
                                          / np.maximum(np.abs(want[:, :4]), 1e-6)).max()))
        worst_a = max(worst_a, float(np.abs(got[:, 4:] - want[:, 4:]).max()))
    log(f"eval step 64x96, gt 75x124, B=2: card vs cpu, continuous metrics {worst_rel:.3e} "
        f"relative (tolerance {TOL_EVAL_CPU:g}), a1-a3 {worst_a:.3e} (tolerance 2/n_valid = "
        f"{2 / n_valid:.3e})")
    if not (worst_rel <= TOL_EVAL_CPU and worst_a <= 2.0 / n_valid):
        raise AssertionError("the eval step on the card disagrees with the CPU")
    return worst_rel, worst_a


def eval_protocol(model, cfg, step, out_dir):
    """save_checkpoint, then cli.eval.evaluate on the saved directory, against
    the mean of the eval step over every test sample at B = 1."""
    import shutil

    import numpy as np

    from packnet_sfm_tpu_torch.cli.eval import evaluate
    from packnet_sfm_tpu_torch.datasets.loader import setup_dataset
    from packnet_sfm_tpu_torch.engine.checkpoint import save_checkpoint
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES

    shutil.rmtree(out_dir, ignore_errors=True)
    path = save_checkpoint(str(out_dir / "ckpt"), model, cfg.to_dict(), epoch=0)
    t0 = time.perf_counter()
    table = evaluate(path)[0]
    secs = time.perf_counter() - t0
    ds = setup_dataset(cfg.datasets.test, "test", cfg.datasets.augmentation, cfg.arch.seed)[0]
    rows = {m: np.zeros((len(ds), 7)) for m in EVAL_MODES}
    for i in range(len(ds)):
        s = ds[i]
        out = step({"rgb": s["rgb"][None], "depth": s["depth"][None]})
        for m in EVAL_MODES:
            rows[m][i] = out[m].cpu().numpy()[0]
    diff = max(float(np.abs(table[m] - rows[m].mean(axis=0)).max()) for m in EVAL_MODES)
    saved = sorted(p.name for p in (out_dir / "save").iterdir())
    log(f"eval protocol: cli.eval.evaluate over {len(ds)} samples in batches of "
        f"{cfg.datasets.test.batch_size} (the last padded) took {secs:.1f} s, model build and "
        f"restore included; its table against the every-sample oracle: max |diff| {diff:.3e} "
        f"(tolerance {TOL_PROTOCOL:g}); {len(saved)} depth files written")
    if not diff <= TOL_PROTOCOL:
        raise AssertionError("the eval protocol disagrees with its every-sample oracle")
    if saved != [f"synthetic_{i:010d}.npz" for i in range(len(ds))]:
        raise AssertionError(f"unexpected depth outputs: {saved}")
    return diff, {m: [float(x) for x in table[m]] for m in EVAL_MODES}


def eval_phase(device, kitti):
    """Phase 5 (see the module docstring); returns its numbers."""
    import torch

    from packnet_sfm_tpu_torch.cli.infer import make_depth_fn
    from packnet_sfm_tpu_torch.engine.factory import setup_metrics_config, setup_model
    from packnet_sfm_tpu_torch.engine.train import (
        eval_forward, eval_metrics, make_eval_step, to_device_float)
    from packnet_sfm_tpu_torch.ops import softargmax as sa
    from packnet_sfm_tpu_torch.ops import warp

    cfg, out_dir = eval_config(kitti)
    h, w = cfg.datasets.augmentation.image_shape
    log(f"eval config: {cfg.model.name}, {cfg.model.depth_net.name}-"
        f"{cfg.model.depth_net.version}, rgb {h}x{w}, gt {EVAL_GT[0]}x{EVAL_GT[1]} at density "
        f"{EVAL_GT_DENSITY}, crop {cfg.model.params.crop!r}, scale_output "
        f"{cfg.model.params.scale_output!r}, float32")
    sa.reset_launch_counts()
    warp.reset_launch_counts()
    model = setup_model(cfg.model, device=device, seed=0)
    metrics_cfg = setup_metrics_config(cfg)
    step = make_eval_step(model, metrics_cfg)
    result = {"config": f"{cfg.model.depth_net.name}-{cfg.model.depth_net.version}, rgb {h}x{w}, "
                        f"gt {EVAL_GT[0]}x{EVAL_GT[1]} at density {EVAL_GT_DENSITY}"}
    for b in (1, 4):
        result[f"B{b}"] = time_eval_steps(step, eval_batches(cfg, b, EVAL_GT))

    batch = eval_batches(cfg, 1, EVAL_GT)
    rgb = to_device_float(batch["rgb"], device)
    gt = to_device_float(batch["depth"], device)
    inv2 = eval_forward(model, rgb)

    def metrics():
        return eval_metrics(inv2, gt, metrics_cfg)

    # one call a round: its host enqueue (a few ms, some hundred small ops)
    # stays under the blocking product, so the events see the device time
    result["metrics_ms"] = time_ms(metrics, reps=1, rounds=10, warmup=2)
    wall = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    result["metrics_wall_ms"] = statistics.median(wall)
    log(f"eval metrics alone (resize to {EVAL_GT[0]}x{EVAL_GT[1]}, flip fusion, 4 modes with "
        f"their sorts), B=1: {result['metrics_ms']:.4f} ms of device time, "
        f"{result['metrics_wall_ms']:.3f} ms on the host's clock (enqueue included)")
    _blocker.clear()
    torch.cuda.empty_cache()

    result["cpu_rel_err"], result["cpu_a_err"] = eval_cpu_reference(model, cfg, metrics_cfg,
                                                                     device)
    result["protocol_max_abs_diff"], result["table"] = eval_protocol(model, cfg, step, out_dir)

    depth_fn = make_depth_fn(model)
    ms = []
    for _ in range(EVAL_STEPS + 1):
        t0 = time.perf_counter()
        inv = depth_fn(rgb)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    straight = eval_forward(model, rgb)[:1]
    rel = ((inv - straight).abs().max() / straight.abs().max()).item()
    med = statistics.median(ms[1:])
    result.update(infer_ms=med, infer_images_per_s=1e3 / med, infer_rel_err=rel)
    log(f"infer depth-only forward [1,{h},{w},3]: median of calls 2-{len(ms)} {med:.2f} ms, "
        f"{1e3 / med:.2f} images/s; against the eval step's straight half {rel:.3e} of the "
        f"largest inverse depth (tolerance {TOL_INFER:g})")
    if not (rel <= TOL_INFER and torch.isfinite(inv).all()):
        raise AssertionError("infer's depth disagrees with the eval step's straight half")

    result["launches"] = {**sa.launch_counts, **warp.launch_counts}
    log(f"launches during eval and infer: {result['launches']}")
    if any(result["launches"].values()):
        raise AssertionError("the eval path launched a kernel of the port")
    return result


def train_config(filepath, max_epochs=TRAIN_EPOCHS):
    """Phase 6's recipe: OVERFIT_PACKNET_SYNTHETIC, cut as the module
    docstring says, its checkpoints under ``filepath``."""
    import copy

    from packnet_sfm_tpu_torch.core.config import OVERFIT_PACKNET_SYNTHETIC

    cfg = copy.deepcopy(OVERFIT_PACKNET_SYNTHETIC)
    cfg["arch"]["max_epochs"] = max_epochs
    cfg["datasets"]["train"]["repeat"] = [TRAIN_REPEAT]
    cfg["checkpoint"].update(filepath=str(filepath), save_top_k=-1)
    return cfg


def parameters(model):
    """The model's trained tensors (no running statistics), on the CPU."""
    return {k: v.detach().cpu().clone() for k, v in model.named_parameters()}


def update_cosine(start, a, b):
    """Cosine of the updates a - start and b - start over all tensors."""
    import torch

    da = torch.cat([(a[k] - start[k]).double().flatten() for k in start])
    db = torch.cat([(b[k] - start[k]).double().flatten() for k in start])
    return float(da @ db / (da.norm() * db.norm()))


def watch_steps(trainer, keep=2, preempt_after=None):
    """Wrap the trainer's step functions: keep the first ``keep`` host
    batches, their losses and the weights after them, and flag a preemption
    once ``preempt_after`` steps have run."""
    seen = {"batches": [], "losses": [], "steps": 0, "after": None}
    build = trainer._train_step_for

    def wrapped(num_scales):
        step = build(num_scales)

        def watched(acc, batch, progress):
            keep_this = len(seen["batches"]) < keep
            before = acc["loss"][0].item() if keep_this else 0.0
            acc = step(acc, batch, progress)
            if keep_this:
                seen["batches"].append(batch)
                seen["losses"].append(acc["loss"][0].item() - before)
                if len(seen["batches"]) == keep:
                    seen["after"] = parameters(trainer.model)
            seen["steps"] += 1
            if preempt_after is not None and seen["steps"] >= preempt_after:
                trainer._preempt_requested = True
            return acc
        return watched
    trainer._train_step_for = wrapped
    return seen


def train_cpu_reference(cfg, start, batches):
    """The first train steps on the CPU from the same weights (``start``, the
    card's state dict), batches and flip generator; returns their losses and
    the weights after them."""
    from packnet_sfm_tpu_torch.cli.train import build_trainer
    from packnet_sfm_tpu_torch.engine.train import zero_metrics

    cpu = build_trainer(dict(cfg, checkpoint={}), device="cpu")
    cpu.model.load_state_dict(start)
    cpu._setup_training()
    step = cpu._train_step_for(TRAIN_SCALES)
    acc, losses, prev = zero_metrics("cpu"), [], 0.0
    for b in batches:
        acc = step(acc, b, 0.0)
        losses.append(acc["loss"][0].item() - prev)
        prev = acc["loss"][0].item()
    return losses, parameters(cpu.model)


def train_phase(device):
    """Phase 6 (see the module docstring); returns its numbers."""
    import re
    import shutil

    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.cli.train import build_trainer, train
    from packnet_sfm_tpu_torch.engine.checkpoint import read_state
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, zero_metrics
    from packnet_sfm_tpu_torch.ops import softargmax as sa
    from packnet_sfm_tpu_torch.ops import warp

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    cfg = train_config(root / "run")
    trainer = build_trainer(cfg, device=device)
    seen = watch_steps(trainer)
    fit_epoch, walls = trainer._fit_epoch, []

    def timed_epoch(epoch):
        t0 = time.perf_counter()
        out = fit_epoch(epoch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    trainer._fit_epoch = timed_epoch
    start = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    net = trainer.config.model.depth_net
    log(f"train config: {trainer.config.model.name}, {net.name}-{net.version} + "
        f"{trainer.config.model.pose_net.name}, lr {trainer.config.model.optimizer.depth.lr:g}, "
        f"64x96, batch {trainer.config.datasets.train.batch_size}, jitter "
        f"{tuple(trainer.config.datasets.augmentation.jittering)}, flip_lr_prob "
        f"{trainer.config.model.loss.flip_lr_prob}; cut to {TRAIN_EPOCHS} epochs, repeat "
        f"[{TRAIN_REPEAT}]")

    torch.cuda.synchronize()
    sa.reset_launch_counts()
    warp.reset_launch_counts()
    history = trainer.fit()
    torch.cuda.synchronize()
    counts = {**sa.launch_counts, **warp.launch_counts}
    steps = trainer.step
    want = {"softargmax_fwd": 0, "softargmax_bwd": 0,
            "warp_fwd": TRAIN_SCALES * steps, "warp_bwd": TRAIN_SCALES * steps}
    log(f"fit: {len(history)} epochs of {trainer.steps_per_epoch} steps; launches {counts}")
    if steps != TRAIN_EPOCHS * trainer.steps_per_epoch or counts != want:
        raise AssertionError(f"{steps} steps, launch counts {counts}, expected {want}")
    for h in history:
        table = np.array([h["val"][0][m] for m in EVAL_MODES])
        if not (np.isfinite(h["loss"]) and np.all(np.isfinite(table))):
            raise AssertionError(f"epoch {h['epoch']}: loss {h['loss']}, table {table}")
    names = sorted(p.name for p in (root / "run").iterdir())
    if not (len(names) == TRAIN_EPOCHS and all(
            re.fullmatch(rf"epoch={e:02d}_depth_gt_abs_rel=[0-9]+\.[0-9]{{3}}\.ckpt", n)
            for e, n in enumerate(names))):
        raise AssertionError(f"unexpected checkpoints: {names}")

    cpu_losses, cpu_after = train_cpu_reference(cfg, start, seen["batches"])
    rel = [abs(a - b) / abs(b) for a, b in zip(seen["losses"], cpu_losses)]
    start = {k: start[k] for k in cpu_after}
    cos = update_cosine(start, seen["after"], cpu_after)
    log("first steps' losses: card " + ", ".join(f"{x:.7f}" for x in seen["losses"])
        + "; cpu " + ", ".join(f"{x:.7f}" for x in cpu_losses)
        + f"; rel {', '.join(f'{x:.2e}' for x in rel)} (tolerance {TOL_LOSS_CPU:g}); "
        f"the two steps' weight update: cosine {cos:.6f} (tolerance {TOL_UPDATE_COS:g})")
    if not (len(rel) == 2 and max(rel) <= TOL_LOSS_CPU and cos >= TOL_UPDATE_COS):
        raise AssertionError("the card's train steps disagree with the CPU's")

    # resume the epoch-0 checkpoint: its epoch 1 against the uninterrupted one
    full = dict(model=parameters(trainer.model), step=trainer.step,
                lrs=[g["lr"] for g in trainer.optimizer.param_groups],
                generator=trainer.generator.get_state().clone())
    epoch0 = read_state(str(root / "run" / names[0]))["model"]
    resumed = train(str(root / "run" / names[0]), device=device)
    got = parameters(resumed.model)

    def norm(diffs):
        return float(torch.sqrt(sum((d.double() ** 2).sum() for d in diffs)))
    moved = norm(full["model"][k] - epoch0[k] for k in full["model"])
    parted = norm(got[k] - full["model"][k] for k in full["model"])
    resume_err = max((got[k] - v).abs().max().item() for k, v in full["model"].items())
    loss_rel = abs(resumed.history[0]["loss"] - history[1]["loss"]) / abs(history[1]["loss"])
    same = (resumed.step == full["step"] and [h["epoch"] for h in resumed.history] == [1]
            and [g["lr"] for g in resumed.optimizer.param_groups] == full["lrs"]
            and torch.equal(resumed.generator.get_state(), full["generator"]))
    log(f"resume of {names[0]}: step {resumed.step}, learning rates, flip generator "
        f"{'equal' if same else 'DIFFERENT'}; epoch-1 weights |resumed - uninterrupted| "
        f"{parted:.4e} against epoch 1's movement {moved:.4e}: {parted / moved:.3e} "
        f"(tolerance {TOL_RESUME:g}), max |diff| {resume_err:.3e}; epoch-1 loss "
        f"{resumed.history[0]['loss']:.7f} against {history[1]['loss']:.7f}, rel "
        f"{loss_rel:.2e} (tolerance {TOL_RESUME_LOSS:g})")
    if not (same and parted <= TOL_RESUME * moved and loss_rel <= TOL_RESUME_LOSS):
        raise AssertionError("the resumed run parts from the uninterrupted one")
    del resumed

    # a preemption after step 1, and its resume
    preempted = build_trainer(train_config(root / "preempt", max_epochs=1), device=device)
    watch_steps(preempted, keep=0, preempt_after=1)
    preempted.fit()
    ckpt = root / "preempt" / "preempt_epoch=00.ckpt"
    meta = json.loads((ckpt / "meta.json").read_text())
    again = train(str(ckpt), device=device)
    log(f"preemption after step 1: {ckpt.name} at epoch {meta['epoch']}, step {meta['step']}, "
        f"{sorted(read_state(str(ckpt)))}; its resume ran epochs "
        f"{[h['epoch'] for h in again.history]} to step {again.step}")
    if not (meta["epoch"] == -1 and meta["step"] == 1 and preempted.history == []
            and [h["epoch"] for h in again.history] == [0]
            and again.step == 1 + again.steps_per_epoch):
        raise AssertionError("the preemption checkpoint does not redo epoch 0")
    del preempted, again

    # the train loader alone over an epoch, with its threads; then the bare
    # step, as phase 4 times it, on its batches
    loader = trainer.train_loaders[0]
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader.epoch(0))
    loader_s = time.perf_counter() - t0
    step = trainer._train_step_for(TRAIN_SCALES)
    batches = [b for _, b in zip(range(BARE_STEPS), loader.epoch(0))]
    acc, step_ms = zero_metrics(device), []
    for b in batches:
        t0 = time.perf_counter()
        acc = step(acc, b, 0.0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    bare = statistics.median(step_ms[1:])
    batch = cfg["datasets"]["train"]["batch_size"]
    epochs = [dict(epoch=h["epoch"], wall_seconds=w,
                   images_per_s=batch * trainer.steps_per_epoch / w,
                   imgs_per_sec=h["imgs_per_sec"], train_seconds=h["seconds"],
                   val_seconds=h["val_seconds"], peak_mib=h["peak_mib"], loss=h["loss"],
                   depth_gt_abs_rel=h["val"][0]["depth_gt"][0])
              for h, w in zip(history, walls)]
    for e in epochs:
        log(f"epoch {e['epoch']}: {e['wall_seconds']:.2f} s wall ({e['images_per_s']:.1f} "
            f"images/s), train {e['train_seconds']:.2f} s ({e['imgs_per_sec']:.1f} imgs/s), "
            f"validation {e['val_seconds']:.2f} s, peak {e['peak_mib']:.1f} MiB, depth_gt "
            f"abs_rel {e['depth_gt_abs_rel']:.4f}")
    log(f"train loader alone: {n_batches} batches in {loader_s:.2f} s "
        f"({loader.num_workers} threads)")
    log(f"bare step (batch {batch}): " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f" ms; median of steps 2-{len(step_ms)} {bare:.2f} ms, {batch / bare * 1e3:.1f} "
        f"images/s; phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return dict(config=f"{net.name}-{net.version} + PoseNet, 64x96, batch {batch}, "
                       f"{TRAIN_EPOCHS} epochs of {trainer.steps_per_epoch} steps",
                epochs=epochs, bare_step_ms=bare, bare_images_per_s=batch / bare * 1e3,
                loader_epoch_seconds=loader_s, cpu_loss_rel=rel, cpu_update_cosine=cos,
                resume_share_of_movement=parted / moved, resume_max_abs_err=resume_err,
                resume_loss_rel=loss_rel, launches=counts,
                seconds=time.perf_counter() - t_phase)


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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())
    rows = softargmax_tile_rows()
    union = (rows + 2 * PATCH, 32 + 2 * PATCH)
    log(f"K6f dynamic shared memory per block at p = {PATCH}: the window union of a "
        f"32 x {rows} pixel tile, 3 x {union[0]} x {union[1]} floats = "
        f"{3 * union[0] * union[1] * 4} bytes, beside the static bytes above")
    k, rows = 2 * PATCH + 1, softargmax_tile_rows("SB_R")
    log(f"K6b dynamic shared memory per block at p = {PATCH}: the pixel union of a 32 x "
        f"{rows} ray tile at 32 bytes a pixel, {32 + k - 1} x {rows + k - 1} pixels = "
        f"{(32 + k - 1) * (rows + k - 1) * 32} bytes for an interior tile, at most 99 KB at a "
        "time; one launch a call")
    log(f"build phase {time.perf_counter() - t0:.1f} s")
    measure_launch_floor(device)

    from packnet_sfm_tpu_torch.geometry.camera_generic import projection_temperature

    cfg, kitti = omnicam_config(), kitti_config()
    measured = kernel_phase(device, cfg.datasets.augmentation.image_shape,
                            projection_temperature(PROGRESS))
    measured.update(warp_kernel_phase(device, path_shapes(kitti)))
    _blocker.clear()                # the timing's 256 MiB matrix: not a part of any step's memory
    torch.cuda.empty_cache()
    nrs_counts, real = slice_phase(device, cfg)
    measured["softargmax_fwd"]["by_case"].append(real["fwd"])
    measured["softargmax_bwd"]["by_case"].append(real["bwd"])
    kitti_counts = flagship_phase(device, kitti)
    torch.cuda.empty_cache()
    evaluated = eval_phase(device, kitti)
    torch.cuda.empty_cache()
    trained = train_phase(device)

    # each kernel's launches are those of the train path it belongs to: the
    # NRS steps for the soft-argmax (they also launch the warp kernels, twice
    # a step each), the flagship steps for the warp
    meta = {
        "softargmax_fwd": ("softargmax", "packnet_sfm_tpu/ops/pallas_softargmax.py:105", nrs_counts),
        "softargmax_bwd": ("softargmax", "packnet_sfm_tpu/ops/pallas_softargmax.py:159", nrs_counts),
        "warp_fwd": ("warp", "docs/bench_pallas_gather_probe.py:102", kitti_counts),
        "warp_bwd": ("warp", "docs/bench_pallas_gather_probe.py:102", kitti_counts),
    }
    kernels = []
    for name, (source, replaces, counts) in meta.items():
        m = measured[name]
        entry = dict(name=name, route="cuda", source=f"packnet_sfm_tpu_torch/csrc/{source}.cu",
                     replaces=replaces, launches=counts[name], max_abs_err=m["max_abs_err"],
                     ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                     bound_by=m["bound_by"], library_ms=m.get("library_ms"))
        for extra in ("by_shape", "by_case"):
            if extra in m:
                entry[extra] = m[extra]
        kernels.append(entry)
    print(json.dumps({"eval": evaluated}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
