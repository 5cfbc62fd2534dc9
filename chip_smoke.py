#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (packnet_sfm_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run:
1. Build every kernel of csrc/ with nvcc for sm_90a, from this checkout.
2. Kernels: K6f/K6b (csrc/softargmax.cu) against their plain PyTorch
   version on seeded inputs at the NRS path's shape, [B,3,192,192], p = 20,
   B = 1 and 2, T = 0.05 and 1e-4, with their times; warp_fwd/warp_bwd
   (csrc/warp.cu) against theirs on coordinates that leave the image on
   every side, exact integer coordinates and -1/+1, both padding modes,
   B = 1 and 8, C = 3 and 1, with d image on, and their times at the four
   shapes of the flagship loss beside F.grid_sample's.
3. NRS slice: the self-supervised train step of configs/train_omnicam.yaml
   (GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet, 384x384, batch 1,
   random weights from seed 0) on synthetic samples: generic_project through
   the kernels against the plain version on the first step's real tensors;
   model_loss on the card against the CPU (plain version) at 96x96; then 5
   train steps at progress 0.5 with the launch counters read around them.
4. Flagship slice: the train step of configs/train_kitti.yaml (SelfSupModel,
   PackNet01-1A + PoseNet, 192x640, batch 4, 4 scales, automask, device
   jitter, the training flip; random weights from seed 0) on synthetic
   samples with intrinsics: view_synthesis through the warp kernels against
   the plain version on the first step's real depths and poses; model_loss
   on the card against the CPU at 64x96; then 5 train steps with the launch
   counters read around them.

Float32 throughout, TF32 off (the configs' bfloat16 policy is not ported
yet). Needs a CUDA device; exits non-zero, printing no result, without one.
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on its train path's steps, error against the
plain version, time, plain time, bound and, where one PyTorch call computes
the same function, that call's time.
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


def log(msg):
    print(msg, flush=True)


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
    proj_err = real_tensor_projection(model, batches[0], device, temperature)
    cpu_reference(model, cfg, device)

    acc = zero_metrics(device)
    counts = run_steps(step, acc, batches, PROGRESS)
    # two contexts at one scale: one projection and one warp each, per step
    want = {"softargmax_fwd": 2 * STEPS, "softargmax_bwd": 2 * STEPS,
            "warp_fwd": 2 * STEPS, "warp_bwd": 2 * STEPS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts, proj_err


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

    cfg, kitti = omnicam_config(), kitti_config()
    measured = kernel_phase(device, cfg.datasets.augmentation.image_shape,
                            projection_temperature(PROGRESS))
    measured.update(warp_kernel_phase(device, path_shapes(kitti)))
    _blocker.clear()                # the timing's 256 MiB matrix: not a part of any step's memory
    torch.cuda.empty_cache()
    nrs_counts, _ = slice_phase(device, cfg)
    kitti_counts = flagship_phase(device, kitti)

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
        if "by_shape" in m:
            entry["by_shape"] = m["by_shape"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
