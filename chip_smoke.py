#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (packnet_sfm_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels     # phases 1 and 2 alone (about a minute)

Phases, each of which fails the run:
1. Build every kernel of csrc/ with nvcc for sm_90a, from this checkout.
2. Kernels: K6f/K6b (csrc/softargmax.cu) against their plain PyTorch
   version on seeded inputs at the NRS path's shape, [B,3,192,192], p = 20,
   B = 1 and 2, T = 0.05 and 1e-4, with their times at the path's
   temperature and at T = 0.05, where no window position is skipped; K6b
   run twice on the same inputs must return the same bits; warp_fwd/warp_bwd
   (csrc/warp.cu) against theirs on coordinates that leave the image on
   every side, exact integer coordinates and -1/+1, both padding modes,
   B = 1, 3 and 8, C = 3, 1 and 4, with d image on, and on a band of half
   the image's rows against the whole image (phase 11's case: [2,384,1280,3]
   at [2,192,1280,2]), and their times at the four
   shapes of the flagship loss beside F.grid_sample's; the bfloat16-image
   variants warp_fwd_bf16/warp_bwd_bf16 on the same cases against the plain
   version on the widened image, and their times at the four shapes beside
   the float32 kernel, the cast + float32 kernel that the wrapper ran before
   them, and image.float() + F.grid_sample; warp_jvp (the coordinate
   tangent) against the plain warp under forward AD on coordinates off
   every side, both padding modes, C = 3, 1 and 4, B = 1 and 3, and its
   time at the odometry path's [1,192,640,3]. warp_bwd_image (the image's
   gradient, float32 and bfloat16) on every warp case above and on one
   where 2000 samples collapse onto a corner under border padding, one
   where the output is 128 times the image, one whose 8 x 32 target tiles
   the image's edge cuts, one with every tap off the image under zeros
   padding (d image exactly 0), and a tile's bin at its 256 records and
   just past them (the walk): within TOL_WARP_GRAD of the plain version
   (bfloat16: beyond a bfloat16 spacing of each element, and the float32
   kernel's result rounded once), the same bits over 3 calls, one of them
   under torch.use_deterministic_algorithms(True); grid_sample under
   autograd with the image requiring a gradient, the call that reaches it
   (no train, eval or odometry path does), launches it once in each dtype;
   the device operations one warp_bwd_image_cuda call enqueues, counted by
   torch.profiler (at most WARP_IMAGE_DEVICE_OPS); its times at the four
   shapes beside the plain version's and F.grid_sample's image gradient.
   channel_conv3d's weight and bias gradient (csrc/fold_conv.cu) against
   its plain version in float64 at PackNet-SAN's and PackNet01's shapes and
   on tiles cut by every edge, both paddings, both dtypes, the same bits on
   a second call, one launch count a call; its time at the three shapes of
   CONV3D_WGRAD_SHAPES beside its bytes bound, the plain version's and
   torch.nn.grad.conv3d_weight's.
3. NRS slice: the self-supervised train step of configs/train_omnicam.yaml
   (GenericSelfSupModel, RaySurfaceResNet-18 + PoseNet, 384x384, batch 1,
   random weights from seed 0) on synthetic samples, as the config says:
   arch.dtype bfloat16, so PoseNet computes in bfloat16 and the ResNet in
   float32 on bfloat16 images, K6 in float32, the warp through the
   bfloat16-image variants. generic_project through the kernels against the
   plain version on the first step's real tensors, and K6f/K6b timed on
   those; model_loss on the card against the CPU (plain version) at 96x96;
   then 5 train steps at progress 0.5 with the launch counters read around
   them; then the same in float32, 3 steps.
4. Flagship slice: the train step of configs/train_kitti.yaml (SelfSupModel,
   PackNet01-1A + PoseNet, 192x640, batch 4, 4 scales, automask, device
   jitter, the training flip; random weights from seed 0) on synthetic
   samples with intrinsics, as the config says: bfloat16 networks and
   images, float32 intrinsics, depths and coordinates. view_synthesis
   through the warp kernels against the plain version on the first step's
   real depths and poses; model_loss on the card against the CPU at 64x96;
   then 5 train steps with the launch counters read around them (the
   bfloat16-image warp 4 times a step); then all of it again in float32.
5. Eval and infer on the flagship model (configs/eval_kitti.yaml's: the
   KITTI config's PackNet01-1A at full width, the Garg crop; random weights
   from seed 0): the flip-fused eval step at 192x640 against ground truth at
   eigen_test's 375x1242 with 4% of its pixels valid, as velodyne gives,
   timed over 10 steps at B = 1 and B = 4, its metric half alone; the step
   on the card against the CPU at 64x96 (gt 75x124); the eval protocol end
   to end (save_checkpoint, then cli.eval.evaluate on a 13-sample Synthetic
   test split in batches of 4, the last one padded) against an every-sample
   oracle; infer's depth-only forward against the eval step's straight
   half. That is float32, eval_kitti.yaml's dtype; then --half: the same
   weights in a bfloat16 model, its eval step timed at B = 1 and 4,
   cli.eval.evaluate(half=True) on the saved checkpoint against the float32
   table (abs_rel of each mode), and infer --half's forward against the
   bfloat16 eval step's straight half. No kernel of the port is on this
   path: the launch counters must read 0 around it.
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
7. Real-format data: trees written under build/chip_smoke_data/ in the
   releases' layouts and at their resolutions (see the constants below):
   a KITTI raw tree, a folder of numbered frames and a DGP scene. Which
   image decoder runs (native, or Pillow with the build's error), and the
   ms to decode a 375x1242 PNG and a 1936x1216 JPEG each way. Then
   ``cli.train`` (build_trainer and fit) on configs/train_kitti.yaml as
   written (bfloat16, PackNet01-1A + PoseNet, 192x640, batch 4, two
   contexts), its splits pointed at the tree and its epoch cut to
   KITTI_TRAIN frames a drive (repeat [2]: 12 steps), validated at native
   ground truth; ``cli.eval.evaluate`` with configs/eval_kitti.yaml (its
   save folder emptied, so that it writes nothing) on that checkpoint at
   B = 4, in ground-truth shape buckets that must be the tree's three
   sizes, against B = 1 (TOL_PROTOCOL); ``cli.infer`` on a 375x1242
   drive. configs/train_omnicam.yaml on the folder (its validation split
   dropped: it has no depth, and a fit validates each epoch). configs/
   train_ddad.yaml on the scene as written (repeat [5]: 10 steps), then
   with two cameras and repeat [1]: 2 steps of 4 images, the batch fold on
   the card. Each fit reads the launch counters around it and fails on
   counts other than the config's per step, a non-finite loss or table;
   each single-camera config's train loader then runs alone over an epoch,
   and the bare step over that epoch's batches.
8. Multi-process training and evaluation (``parallel/``), each run started
   by ``torch.distributed.run --standalone``, one process a rank (the
   ranks of a job are ``chip_smoke.py --worker <job.json>``): world 1 over
   NCCL through ``cli.train --distributed``, phase 7's train_kitti.yaml run
   again, whose loss and validation table must equal phase 7's (run
   without it), beside it NCCL's refusal of two ranks on one card; the
   train_kitti.yaml step at batch 4 timed plain and with DDP at world 1
   (``parallel/scaling.py``, which also gives images/s and efficiency at the
   world sizes the machine has cards for), each in a fresh process. Two
   ranks: NCCL with a card a rank where there are two cards, else gloo with
   both on card 0, after NCCL's refusal of that is shown
   and its message kept. On two ranks: the first train_kitti.yaml step as
   written (4 rows a rank) against one rank on the 8 rows (the ranks'
   mean loss, the gradient's cosine; the update's cosine against one rank
   that takes the 8 rows in the ranks' two halves, and beside it against
   one rank on the 8 at once); train_omnicam.yaml on phase 7's folder
   (K6f, K6b and the bfloat16 warp launched on each rank, 2 a step, read
   around the fit on each rank; the ranks' epoch losses equal);
   eval_kitti.yaml on phase 7's checkpoint, whose table must equal phase
   7's one-rank table; phase 6's recipe at repeat [DRAIN_REPEAT] with
   SIGTERM to rank 1 alone, both ranks drained at one step, rank 0's
   preempt_epoch=00.ckpt, and a two-rank resume that finishes the epoch.
   Two ranks on one card are correctness runs, not speed figures; the
   line says so.
9. The remaining networks and model kinds, on phase 7's trees:
   train_packnet_san_kitti.yaml (PackNet-SAN, groundtruth depth, velodyne
   input depth, batch 1, with a 352x1216 crop for its borders): its loss
   terms and inverse depths on the card against the CPU at 64x96, one
   epoch, then the eval protocol with and without input depth, float32 and
   --half, and infer; train_packnet_san_ddad.yaml with lidar input depth;
   overfit_packnet_supervised.yaml to the JAX package's bar;
   overfit_kitti.yaml at ResNet-18 and -50; VelSup on train_kitti.yaml's
   networks with OXTS poses. Each run's launch counters against what its
   config launches a step.
10. Ego-motion, export and conversion, on phase 7's KITTI tree and its
   train_kitti.yaml checkpoint (PackNet01-1A + PoseNet, full width, 192x640;
   cli.odometry builds it in float32, as the JAX CLI does): cli.odometry
   over the first drive's 20 frames plain, with --refine-direct and with
   both refinements, --gt the drive's OXTS poses in KITTI odometry format,
   then each on the first 3 frames on the card and on the CPU against each
   other (the CPU would take minutes over the drive), the launch counters read
   around each run (warp_jvp 19 x 8 x 6 = 912 times with --refine-direct,
   0 without); warp_jvp on the first pair's real depth and pose against the
   plain warp under forward AD; the native solver against
   optimize_pose_graph on the run's first window, and
   optimize_pose_graph_sharded on two gloo ranks of card 0 (phase 8's
   ``--worker``) against one process; cli.export of the checkpoint, float32
   and --half, run in a fresh process that imports only torch, against
   infer's forward; cli.convert_checkpoint of a reference-format .ckpt that
   the phase writes from the same weights under the reference's names, whose
   inverse depth must equal the original's.
11. The (data x space) grid (``parallel/mesh.make_mesh_2d``,
   ``parallel/spatial.py``): tools/hr_2dmesh.py's HR step (the JAX
   package's docs/bench_hr_2dmesh.py recipe: PackNet01-1A + PoseNet at full
   width, float32, remat on, 384x1280, batch 1, from seed 0) for
   SPACE_STEPS steps in one process as the recipe runs it (the fused pack
   conv), in one process with the two-step pack conv, and on two space
   ranks over gloo on card 0, each band 192 rows; the grid's first loss
   and first Adam update against the two-step process's, its loss against
   the fused one's, each rank's peak below the fused process's, and 4
   launches of warp_fwd and warp_bwd a step on each rank, at band
   coordinates against whole images (phase 2 holds the four warp kernels
   on that case).
12. The rest of the grid's kinds (``models/sfm.check_band``): (a) the band
   forms of K6f/K6b (softargmax_fwd_band/softargmax_bwd_band) at the
   omnicam projection grid, [1,3,192,192], p = 20, on the bands at rows 0
   and 96 of 2 (each with its ray slab), against their plain band versions,
   ex, ey and d direction against the same rows of the whole-image kernel,
   the bands' d rays summed as the halo's backward sums them against the
   whole d rays; their times and bounds; then tools/hr_2dmesh.py's recipes
   for SPACE_KIND_STEPS steps, in one process (the two-step pack conv) and
   on two space ranks over gloo on card 0: (b) ``hr_velsup`` (VelSupModel on
   the HR networks at 384x1280) against the one process, its loss, velocity
   term and first update; (c) ``omnicam`` (NRS at 384x384, float32) against
   the one process, the first loss and the first gradient's cosine above
   the port's own floor (one process from weights perturbed by 1e-7,
   measured here), 2 launches of each band form a step on each rank; then
   in bfloat16, as the config is written; (d) ``semisup`` (PackNet01 as
   SemiSupModel with sparse-berhu at 192x640) against the one process.

Phases 3 and 4 train in bfloat16 as the configs say, and in float32 beside
it; phase 6 in float32 (the overfit recipes' dtype). TF32 stays off for
float32 work; bfloat16 convolutions use the tensor cores regardless. Needs
a CUDA device; exits non-zero, printing no result, without one.
The last line is {"ok": true, "device": {...}}; before the kernels' line,
one line {"steps": {...}} holds phases 3 and 4's steps by dtype, one line
{"eval": {...}} phase 5's numbers, one line {"train": {...}} phase 6's,
one line {"data": {...}} phase 7's, one line {"distributed": {...}}
phase 8's (with "backend" and "ranks_per_card"), one line {"models":
{...}} phase 9's, one line {"odometry": {...}} phase 10's, one line
{"space": {...}} phase 11's and one line {"space_kinds": {...}} phase 12's.
The line before the last lists each kernel with its dtype, its launches on
its train path's steps (the bfloat16 steps; the float32-image warp's on the
float32 flagship steps), error against the plain version, time, plain
time, bound and, where one PyTorch call computes the same function, that
call's time, and each kernel's launches on phase 7's runs
("data_launches"), by rank on phase 8's ("distributed_launches"), by
run on phase 9's ("models_launches"), on phase 10's
("odometry_launches"), by run and rank on phase 11's ("space_launches")
and on phase 12's ("space_kinds_launches"); warp_jvp's launches are the
--refine-direct run's, the band forms' those of phase 12's omnicam grid. A
bound is the largest of the bytes' time, the operations' time and the time
of an empty kernel's launch, measured here.
"""

import contextlib
import gc
import io
import json
import math
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
# pixel in another order (measured 2e-7); d image sums each pixel's taps in
# key order, one fixed order, where the plain version's scatter takes its
# own (measured 2.2e-6 on an H100 with 8000 taps on one pixel).
TOL_WARP_FWD = 1e-5
TOL_WARP_GRAD = 1e-4
# warp_bwd_image, the warp's image gradient (a gather over an index binned
# by tiles of target pixels): per output pixel the function must read the
# coordinates (8 B) and the cotangent (4C B) and write d image (4C B a
# source pixel); FP32 operations ~24 for the coordinates and weights, then a
# multiply-add (2) a tap and channel. Its index moves some 9 B a pixel more,
# which bound_with_index_ms adds: the sum pass reads the coordinates again
# (8 B), and a smooth warp writes and reads ~2.3 records of 8 B for each
# 32 output pixels (~1.2 B), beside a 4 B count a tile of 256 pixels.
WARP_IMAGE_OPS = (24, 8)
WARP_IMAGE_INDEX_BYTES = 9
# At most this many device operations (kernels and memsets) a call of
# warp_bwd_image_cuda: the counts' memset, place and sum.
WARP_IMAGE_DEVICE_OPS = 4
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
# bfloat16 (the configs' arch.dtype). The card against the CPU: both round
# activations to bfloat16 at every layer, in orders cuDNN and oneDNN pick,
# so the losses part by more than float32's (TOL_LOSS_CPU); measured on an
# H100 2.3e-4 (NRS, whose soft-argmax at T ~ 1e-4 amplifies it) and 1.6e-5
# (flagship). Eval --half against float32 on the same random weights:
# abs_rel in each mode, relative (measured 1.7e-3 at most). Infer --half
# against its eval step's straight half (B = 1 against B = 2 of the same
# image: bfloat16 convolutions of another batch may take another
# algorithm, which rounds otherwise), relative to the largest inverse depth
# (measured 6.4e-3).
TOL_LOSS_CPU_BF16 = 2e-3
TOL_HALF_ABS_REL = 1e-2
TOL_INFER_HALF = 2e-2
NRS_F32_STEPS = 3
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


def prepared(batch, device, dtype):
    """The train step's device half of a host batch: decode, jitter and, in
    bfloat16, the cast of the images."""
    from packnet_sfm_tpu_torch.engine.train import cast_batch, prepare_train_batch

    b = prepare_train_batch(batch, device)
    return b if dtype is None else cast_batch(b, dtype)


def cpu_reference(model, cfg, device, dtype):
    """model_loss at 96x96 on the card (kernels) and on the CPU (plain
    version) with the same weights, in the model's compute dtype."""
    import torch

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.models.sfm import model_loss

    s = SyntheticSfmDataset(length=1, height=96, width=96, seed=7)[0]
    batch = {"rgb": s["rgb"][None], "rgb_context": [c[None] for c in s["rgb_context"]]}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    cpu_model = setup_model(cfg.model, device="cpu", dtype=dtype)
    cpu_model.load_state_dict({k: v.cpu() for k, v in state.items()})
    with torch.no_grad():
        gpu_loss = model_loss(model, prepared(batch, device, dtype), PROGRESS)[0].item()
        cpu_loss = model_loss(cpu_model, prepared(batch, "cpu", dtype), PROGRESS)[0].item()
    model.load_state_dict(state)
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    tol = TOL_LOSS_CPU if dtype is None else TOL_LOSS_CPU_BF16
    log(f"model_loss 96x96, {dtype_name(dtype)}: card {gpu_loss:.7f} cpu {cpu_loss:.7f} "
        f"rel {rel:.2e} (tolerance {tol:g})")
    if not rel <= tol:
        raise AssertionError("model_loss on the card disagrees with the CPU")
    return rel


def dtype_name(dtype):
    return "float32" if dtype is None else str(dtype).removeprefix("torch.")


def slice_phase(device, cfg):
    """Phase 3: the NRS step as its config says (bfloat16), then in float32
    beside it. Returns ({dtype: the steps' numbers}, K6's real-field rows)."""
    import torch

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset
    from packnet_sfm_tpu_torch.engine.factory import compute_dtype, make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
    from packnet_sfm_tpu_torch.geometry.camera_generic import projection_temperature

    H, W = cfg.datasets.augmentation.image_shape
    dtype = compute_dtype(cfg)
    log(f"config: {cfg.model.name}, {cfg.model.depth_net.name}-{cfg.model.depth_net.version} "
        f"+ {cfg.model.pose_net.name}, {H}x{W}, batch {cfg.datasets.train.batch_size}, "
        f"arch.dtype {cfg.arch.dtype}: PoseNet computes in {dtype_name(dtype)}, the ResNet in "
        f"float32 on {dtype_name(dtype)} images; then {NRS_F32_STEPS} float32 steps")
    temperature = projection_temperature(PROGRESS)
    ds = SyntheticSfmDataset(length=STEPS, height=H, width=W, seed=0)
    batches = []
    for i in range(STEPS):
        s = ds[i]
        batches.append({"rgb": s["rgb"][None], "rgb_context": [c[None] for c in s["rgb_context"]]})

    result = {}
    for dt, n in ((dtype, STEPS), (None, NRS_F32_STEPS)):
        model = setup_model(cfg.model, device=device, seed=0, dtype=dt)
        optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                              steps_per_epoch=len(ds))
        step = make_train_step(model, optimizer, scheduler,
                               compute_dtype=dt or torch.float32)
        if dt is dtype:
            proj_err, (direction, rays) = real_tensor_projection(model, batches[0], device,
                                                                 temperature)
            real = time_softargmax(direction, rays, temperature,
                                   f"the first step's direction and ray fields, "
                                   f"T={temperature:.3e}")
            del direction, rays
            _blocker.clear()        # the timing's 256 MiB matrix: not a part of the steps' memory
            torch.cuda.empty_cache()
        rel = cpu_reference(model, cfg, device, dt)
        log(f"NRS train steps, {dtype_name(dt)}:")
        counts, stats = run_steps(step, zero_metrics(device), batches[:n], PROGRESS)
        # two contexts at one scale: one projection and one warp each, per step,
        # the warp through the variant of the images' dtype
        suffix = "" if dt is None else "_bf16"
        want = {key: 0 for key in counts}
        want.update({"softargmax_fwd": 2 * n, "softargmax_bwd": 2 * n,
                     "warp_fwd" + suffix: 2 * n, "warp_bwd" + suffix: 2 * n})
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        result[dtype_name(dt)] = dict(stats, launches=counts, cpu_loss_rel=rel)
        del model, optimizer, scheduler, step
        torch.cuda.empty_cache()
    return result, real


def run_steps(step, acc, batches, progress):
    """Drive the train steps with every launch counter set to 0 just before
    and read just after; returns the counts and {step_ms (median of the
    steps after the first), images_per_s, peak_mib, losses}."""
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
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log("losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log("step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median of steps 2-{len(batches)}: {statistics.median(step_ms[1:]):.2f} ms")
    log(f"peak memory allocated: {peak / 2**20:.1f} MiB; launches: {counts}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    med = statistics.median(step_ms[1:])
    images = len(batches[0]["rgb"])
    return counts, dict(step_ms=med, images_per_s=images / med * 1e3,
                        peak_mib=peak / 2**20, losses=losses)


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


def image_grad_checks(warp, coords, grad, hw, pad, d_image, want):
    """warp_bwd_image's bits over 3 calls (the first is ``d_image``), one of
    them under deterministic algorithms, and its bfloat16 form: the float32
    result rounded once, within TOL_WARP_GRAD of the largest beyond a
    bfloat16 spacing of each element of the plain version ``want``.
    Returns the bfloat16 form's largest absolute error."""
    import torch

    again = warp.warp_bwd_image_cuda(coords, grad, hw, torch.float32, pad)
    torch.use_deterministic_algorithms(True)
    try:
        deterministic = warp.warp_bwd_image_cuda(coords, grad, hw, torch.float32, pad)
        d16 = warp.warp_bwd_image_cuda(coords, grad, hw, torch.bfloat16, pad)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -120))) - 7)
    e16 = ((d16.float() - want).abs() - spacing).clamp(min=0).max().item() / \
        max(want.abs().max().item(), 1e-30)
    same = torch.equal(again, d_image) and torch.equal(deterministic, d_image)
    log(f"warp_bwd_image: the same bits over 3 calls {same}; bfloat16 {e16:.3e} of the "
        f"largest beyond its spacing, the float32 result rounded "
        f"{torch.equal(d16, d_image.bfloat16())}")
    if not (same and torch.equal(d16, d_image.bfloat16()) and e16 <= TOL_WARP_GRAD):
        raise AssertionError("warp_bwd_image: differing bits or a wrong bfloat16 form")
    return (d16.float() - want).abs().max().item()


def image_grad_launches(warp, device, shape):
    """The call that reaches warp_bwd_image: grid_sample under autograd with
    the image requiring a gradient, at ``shape`` = (B, H, W), C = 3, float32
    and bfloat16 images; the counts read around each."""
    import torch

    gen = torch.Generator().manual_seed(4)
    b, h, w = shape
    coords = smooth_coords(gen, b, h, w, device)
    grad = torch.randn((b, h, w, 3), generator=gen).to(device)
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        image = torch.rand((b, h, w, 3), generator=gen).to(device, dtype).requires_grad_()
        reset_counts()
        warp.grid_sample(image, coords).backward(grad)
        torch.cuda.synchronize()
        launches.update({k: v for k, v in read_counts().items() if v})
        if image.grad is None or image.grad.dtype != dtype or \
                not torch.isfinite(image.grad).all():
            raise AssertionError(f"no finite {dtype} image gradient through grid_sample")
    want = {"warp_fwd": 1, "warp_bwd_image": 1, "warp_fwd_bf16": 1, "warp_bwd_image_bf16": 1}
    log(f"grid_sample's image gradient at [{b},{h},{w},3], float32 and bfloat16: launches "
        f"{launches}")
    if launches != want:
        raise AssertionError(f"image gradient launches {launches}, expected {want}")
    return launches


def image_grad_device_ops(warp, device, shape):
    """The device operations (kernels and memsets) that one call of
    warp_bwd_image_cuda enqueues at ``shape`` = (B, H, W), C = 3, counted by
    torch.profiler over 5 calls after a warm-up, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(5)
    b, h, w = shape
    coords = smooth_coords(gen, b, h, w, device)
    grad = torch.randn((b, h, w, 3), generator=gen).to(device)
    for _ in range(3):
        warp.warp_bwd_image_cuda(coords, grad, (h, w))
    torch.cuda.synchronize()
    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            warp.warp_bwd_image_cuda(coords, grad, (h, w))
        torch.cuda.synchronize()
    names = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            name = event.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = "memset" if "Memset" in name else name.split("(")[0].split("<")[0]
            names[name] = names.get(name, 0) + 1
    per_call = sum(names.values()) / calls
    log(f"warp_bwd_image_cuda at [{b},{h},{w},3]: {per_call:g} device operations a call "
        f"(torch.profiler over {calls} calls: {names}; at most {WARP_IMAGE_DEVICE_OPS})")
    if not 0 < per_call <= WARP_IMAGE_DEVICE_OPS:
        raise AssertionError(f"warp_bwd_image_cuda enqueues {per_call:g} device operations")
    return per_call


def warp_kernel_phase(device, shapes):
    """warp_fwd/warp_bwd/warp_bwd_image against the plain version, then
    their times at the flagship loss's shapes beside the plain version's and
    F.grid_sample's, and the launches of the call that reaches
    warp_bwd_image."""
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
    # a band of rows against the whole image, as phase 11's grid warps: the
    # HR recipe's finest scale (two contexts, 384x1280, space 2) and a small
    # band in border mode
    cases += [(2, 384, 1280, 3, 192, 1280, "zeros"), (3, 48, 160, 1, 24, 160, "border")]
    # the image gradient's crowded targets: 2000 samples collapsed onto the
    # bottom-right pixel (8000 taps on it), and an output 128 times the
    # image (some 500 taps a pixel); its tiles of 8 x 32 targets cut by the
    # image's edge (13 x 45); every tap off the image under 'zeros' (d image
    # exactly 0); a tile's bin at its 256 records (an 8 x 32 image, one tile,
    # under 64 x 128 outputs: 256 warps) and just past it (64 x 130: 260
    # warps, the walk)
    collapsed, outside = (1, 48, 160, 3, 48, 160, "border"), (2, 24, 80, 3, 24, 80, "zeros")
    cases += [collapsed, (2, 6, 10, 3, 48, 160, "zeros"), (2, 13, 45, 3, 20, 50, "border"),
              outside, (1, 8, 32, 3, 64, 128, "zeros"), (1, 8, 32, 3, 64, 130, "border")]
    for b, h, w, c, ho, wo, pad in cases:
        image, coords, grad = warp_inputs(gen, b, h, w, c, ho, wo, device, spread=1.3)
        if (b, h, w, c, ho, wo, pad) == collapsed:
            coords.view(-1, 2)[:2000] = torch.tensor([3.0, 2.5], device=device)
        if (b, h, w, c, ho, wo, pad) == outside:
            coords += 3.0
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
        rel = max(e_dc / max(cp.grad.abs().max().item(), 1e-30),
                  e_di / max(ip.grad.abs().max().item(), 1e-30))
        if (b, h, w, c, ho, wo, pad) == outside and not bool((d_image == 0).all()):
            raise AssertionError("warp_bwd_image: a tap off the image reached d image")
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
        err["bwd"] = max(err["bwd"], e_dc)
        err["bwd_image"] = max(err.get("bwd_image", 0.0), e_di)
        err["bwd_image_bf16"] = max(err.get("bwd_image_bf16", 0.0),
                                    image_grad_checks(warp, coords, grad, (h, w), pad,
                                                      d_image, ip.grad))

        # the bfloat16-image variants on the same case: the plain version on
        # the widened image is the same function
        img16 = image.bfloat16()
        out16 = warp.warp_fwd_cuda(img16, coords, pad)
        _, d_coords16 = warp.warp_bwd_cuda(img16, coords, grad, pad)
        torch.cuda.synchronize()
        cp = coords.clone().requires_grad_()
        out_p = warp.grid_sample_plain(img16.float(), cp, pad)
        (out_p * grad).sum().backward()
        e_fwd = (out16 - out_p).abs().max().item()
        e_dc = (d_coords16 - cp.grad).abs().max().item()
        rel = e_dc / max(cp.grad.abs().max().item(), 1e-30)
        log(f"warp bf16 image, same case: max |d out| {e_fwd:.3e}; d_coords {e_dc:.3e}, "
            f"{rel:.3e} of the largest")
        if not (e_fwd <= TOL_WARP_FWD and rel <= TOL_WARP_GRAD):
            raise AssertionError("bfloat16-image warp kernel disagrees with its plain version")
        if not (torch.isfinite(out16).all() and torch.isfinite(d_coords16).all()):
            raise AssertionError("non-finite bfloat16-image warp kernel output")
        err["fwd_bf16"] = max(err.get("fwd_bf16", 0.0), e_fwd)
        err["bwd_bf16"] = max(err.get("bwd_bf16", 0.0), e_dc)

    # times at the main path's shapes: zeros padding, C = 3, image and output
    # of one size, the image is data (no d image), then warp_bwd_image
    gen = torch.Generator().manual_seed(1)
    rows = {"fwd": [], "bwd": [], "fwd_bf16": [], "bwd_bf16": [], "bwd_image": [],
            "bwd_image_bf16": []}
    for b, h, w in shapes:
        image = torch.rand((b, h, w, 3), generator=gen).to(device)
        coords = smooth_coords(gen, b, h, w, device)
        grad = torch.randn((b, h, w, 3), generator=gen).to(device)
        nchw = image.permute(0, 3, 1, 2)

        def library(c, im=nchw):
            return F.grid_sample(im, c, mode="bilinear", padding_mode="zeros",
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

        # the bfloat16 image: the variants beside the float32 kernel on the
        # widened image and the route they replace, image.float() then
        # F.grid_sample (no one PyTorch call takes a bfloat16 image at float32
        # coordinates, so library_ms is null)
        img16 = image.bfloat16()
        k_fwd = time_ms(lambda: warp.warp_fwd_cuda(img16, coords))
        k_bwd = time_ms(lambda: warp.warp_bwd_cuda(img16, coords, grad))
        with torch.no_grad():
            p_fwd = time_ms(lambda: warp.grid_sample_plain(img16.float(), coords))
            r_fwd = time_ms(lambda: library(coords, img16.float().permute(0, 3, 1, 2)))
            # what the wrapper did before the variants: the cast, then the
            # float32 kernel
            c_fwd = time_ms(lambda: warp.warp_fwd_cuda(img16.float(), coords))
        cp = coords.clone().requires_grad_()
        out_p = (warp.grid_sample_plain(img16.float(), cp) * grad).sum()
        p_bwd = time_ms(lambda: torch.autograd.grad(out_p, cp, retain_graph=True))
        cl = coords.clone().requires_grad_()
        out_l = (library(cl, img16.float().permute(0, 3, 1, 2)) * grad.permute(0, 3, 1, 2)).sum()
        r_bwd = time_ms(lambda: torch.autograd.grad(out_l, cl, retain_graph=True))
        # forward: coords 8 B, image 6 B, output 12 B per pixel; the backward
        # reads the cotangent (12 B) and writes d coords (8 B), no output
        bounds = {"fwd": bound_ms(px * (8 + 6 + 12), px * (WARP_OPS["fwd"][0] + 3 * WARP_OPS["fwd"][1])),
                  "bwd": bound_ms(px * (8 + 6 + 12 + 8), px * (WARP_OPS["bwd"][0] + 3 * WARP_OPS["bwd"][1]))}
        f32 = {"fwd": rows["fwd"][-1]["ms"], "bwd": rows["bwd"][-1]["ms"]}
        cast = {"fwd": c_fwd, "bwd": f32["bwd"]}       # the backward has no cast
        for key, k, pl, route in (("fwd", k_fwd, p_fwd, r_fwd), ("bwd", k_bwd, p_bwd, r_bwd)):
            rows[key + "_bf16"].append(dict(
                shape=[b, h, w, 3], ms=k, plain_ms=pl, bound_ms=bounds[key][0],
                bound_by=bounds[key][1], library_ms=None, float32_kernel_ms=f32[key],
                cast_kernel_ms=cast[key], cast_grid_sample_ms=route))
            log(f"warp_{key}_bf16 at [{b},{h},{w},3]: kernel {k:.4f} ms, float32 kernel "
                f"{f32[key]:.4f}, image.float() + float32 kernel {cast[key]:.4f}, "
                f"image.float() + F.grid_sample {route:.4f}, plain {pl:.3f}, "
                f"bound {bounds[key][0]:.4f} ({bounds[key][1]})")

        # the image's gradient: warp_bwd_image against the plain version's
        # autograd and F.grid_sample's backward for the image alone (its
        # bfloat16 form has no one PyTorch call: library_ms null)
        ip, ip16 = image.clone().requires_grad_(), img16.clone().requires_grad_()
        out_p = (warp.grid_sample_plain(ip, coords) * grad).sum()
        out_p16 = (warp.grid_sample_plain(ip16.float(), coords) * grad).sum()
        nl = nchw.clone().requires_grad_()
        out_l = (library(coords, nl) * grad.permute(0, 3, 1, 2)).sum()
        times = {
            "bwd_image": (time_ms(lambda: warp.warp_bwd_image_cuda(coords, grad, (h, w))),
                          time_ms(lambda: torch.autograd.grad(out_p, ip, retain_graph=True)),
                          time_ms(lambda: torch.autograd.grad(out_l, nl, retain_graph=True))),
            "bwd_image_bf16": (
                time_ms(lambda: warp.warp_bwd_image_cuda(coords, grad, (h, w), torch.bfloat16)),
                time_ms(lambda: torch.autograd.grad(out_p16, ip16, retain_graph=True)), None)}
        for key, d_bytes in (("bwd_image", 12), ("bwd_image_bf16", 6)):
            # coords 8 B and the cotangent 12 B read, d image written, a pixel
            n_bytes = px * (8 + 12 + d_bytes)
            n_ops = px * (WARP_IMAGE_OPS[0] + 3 * WARP_IMAGE_OPS[1])
            bound, by = bound_ms(n_bytes, n_ops)
            k, pl, lib = times[key]
            with_index = bound_ms(n_bytes + px * WARP_IMAGE_INDEX_BYTES, n_ops)[0]
            rows[key].append(dict(shape=[b, h, w, 3], ms=k, plain_ms=pl, bound_ms=bound,
                                  bound_by=by, library_ms=lib, bound_with_index_ms=with_index))
            log(f"warp_{key} at [{b},{h},{w},3]: kernel {k:.4f} ms, plain {pl:.3f}, "
                f"F.grid_sample {'n/a' if lib is None else f'{lib:.4f}'}, bound {bound:.4f} "
                f"({by}), with its index's bytes {with_index:.4f}")
        del out_p, out_p16, out_l
    # the line's headline numbers are those of the finest scale; the other
    # three scales go along under by_shape
    result = {f"warp_{key}": dict(max_abs_err=err[key], by_shape=rows[key],
                                  dtype="bfloat16" if key.endswith("bf16") else "float32",
                                  **{k: v for k, v in rows[key][0].items() if k != "shape"})
              for key in rows}
    launches = image_grad_launches(warp, device, shapes[0])
    device_ops = image_grad_device_ops(warp, device, shapes[0])
    for key in ("warp_bwd_image", "warp_bwd_image_bf16"):
        result[key]["path_launches"] = launches
        result[key]["device_ops"] = device_ops
    return result


# warp_jvp (the warp's coordinate tangent) at the ego-motion path's shape:
# one target frame at the train_kitti.yaml resolution. FP32 operations per
# output pixel: coordinates, taps and weights ~20, then 12 a channel.
ODOMETRY_SHAPE = (1, 192, 640)
WARP_JVP_OPS = (20, 12)


def warp_jvp_kernel_phase(device):
    """warp_jvp against the plain warp under forward AD on seeded cases
    (coordinates off every side, exact integers and -1/+1, both paddings,
    C = 3, 1 and 4, B = 1 and 3), then its time at the odometry path's
    shape beside the plain version's and, where PyTorch has a forward-mode
    rule for it, torch.func.jvp of F.grid_sample."""
    import torch
    import torch.nn.functional as F

    from packnet_sfm_tpu_torch.ops import warp

    def plain(image, coords, tangent, pad="zeros"):
        return torch.func.jvp(lambda c: warp.grid_sample_plain(image, c, pad),
                              (coords,), (tangent,))[1]

    gen = torch.Generator().manual_seed(2)
    worst, cases = 0.0, []
    for b in (1, 3):
        for c in (3, 1, 4):
            for pad in ("zeros", "border"):
                image, coords, _ = warp_inputs(gen, b, 33, 71, c, 37, 75, device, spread=1.3)
                tangent = torch.randn(coords.shape, generator=gen).to(device)
                got = warp.warp_jvp_cuda(image, coords, tangent, pad)
                torch.cuda.synchronize()
                want = plain(image, coords, tangent, pad)
                rel = (got - want).abs().max().item() / want.abs().max().item()
                log(f"warp_jvp B={b} 33x71x{c} -> 37x75 {pad}: max |d tangent| {rel:.3e} of "
                    f"the largest (tolerance {TOL_WARP_GRAD:g})")
                if not (torch.isfinite(got).all() and rel <= TOL_WARP_GRAD):
                    raise AssertionError("warp_jvp disagrees with its plain version")
                worst = max(worst, rel)
                cases.append(dict(b=b, c=c, padding=pad, rel_err=rel))

    b, h, w = ODOMETRY_SHAPE
    gen = torch.Generator().manual_seed(3)
    image = torch.rand((b, h, w, 3), generator=gen).to(device)
    coords = smooth_coords(gen, b, h, w, device)
    tangent = (torch.randn((b, h, w, 2), generator=gen) * 1e-2).to(device)
    k = time_ms(lambda: warp.warp_jvp_cuda(image, coords, tangent))
    p = time_ms(lambda: plain(image, coords, tangent))
    nchw = image.permute(0, 3, 1, 2)
    try:
        lib = time_ms(lambda: torch.func.jvp(
            lambda c: F.grid_sample(nchw, c, mode="bilinear", padding_mode="zeros",
                                    align_corners=True), (coords,), (tangent,)))
        lib_note = f"torch.func.jvp of F.grid_sample {lib:.4f} ms"
    except (NotImplementedError, RuntimeError) as e:
        lib = None
        lib_note = f"torch.func.jvp of F.grid_sample raises: {str(e).splitlines()[0]}"
    px = b * h * w
    # the image (12 B), coordinates (8 B) and their tangent (8 B) read once,
    # the tangent out (12 B) written once, per pixel
    bound = bound_ms(px * (12 + 8 + 8 + 12), px * (WARP_JVP_OPS[0] + 3 * WARP_JVP_OPS[1]))
    log(f"warp_jvp at [{b},{h},{w},3]: kernel {k:.4f} ms, plain (forward AD) {p:.3f}, "
        f"bound {bound[0]:.4f} ({bound[1]}); {lib_note}")
    return {"warp_jvp": dict(max_abs_err=worst, ms=k, plain_ms=p, bound_ms=bound[0],
                             bound_by=bound[1], library_ms=lib, library_note=lib_note,
                             dtype="float32", by_case=cases)}


# channel_conv3d's weight gradient (csrc/fold_conv.cu): (name, B, Cp, H, W, d,
# dtype) of the timed shapes, the main path's, and (B, Cp, Hin, W, d, row
# padding, dtype) of the checked cases beyond them: tiles cut by every edge,
# d of each register blocking (4, 2, 1), the band's padding with its halo
# rows attached.
CONV3D_WGRAD_SHAPES = (("san_unpack1", 1, 32, 176, 608, 4, "float32"),
                       ("san_pack5", 1, 2048, 11, 38, 4, "float32"),
                       ("packnet01_b16_unpack1", 16, 32, 96, 320, 8, "bfloat16"))
CONV3D_WGRAD_CASES = ((2, 3, 13, 45, 4, 1, "float32"), (1, 17, 9, 33, 8, 1, "bfloat16"),
                      (1, 8, 12, 40, 4, 0, "float32"), (2, 20, 7, 70, 8, 0, "bfloat16"),
                      (1, 5, 6, 31, 6, 1, "float32"), (1, 1, 5, 7, 3, 0, "float32"))
# float32 sums of up to 3.4 M products against float64: relative to the
# largest of dW and of db
TOL_CONV3D_WGRAD = 1e-5


def conv3d_wgrad_kernel_phase(device):
    """channel_conv3d's weight and bias gradient kernel against its plain
    version in float64 (bfloat16: within one bfloat16 spacing of the
    float64 sum, which the float32 sum rounded once is), the same bits on
    a second call and one launch count a call, on the timed shapes and the
    cases above; then its time at the timed shapes beside its bound (x and
    dy read once at HBM_BYTES_PER_S, or 27 d + d FP32 operations a voxel),
    the plain version's time and torch.nn.grad.conv3d_weight's (cuDNN's
    weight gradient alone, no bias; the port never calls it)."""
    import torch

    from packnet_sfm_tpu_torch.ops import fold_conv
    from portbench.yardstick import HBM_BYTES_PER_S

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator().manual_seed(4)

    def inputs(b, cp, hin, w, d, ph, dt):
        h = hin + 2 * ph - 2
        x = torch.randn((b, 1, cp, hin, w), generator=gen).to(device, dtypes[dt])
        g = torch.randn((b, d, cp, h, w), generator=gen).to(device, dtypes[dt])
        return x, g, (1, ph, 1)

    def check(label, x, g, pad):
        before = fold_conv.launch_counts["channel_conv3d_wgrad"]
        dw, db = fold_conv.channel_conv3d_wgrad_cuda(x, g, pad)
        dw2, db2 = fold_conv.channel_conv3d_wgrad_cuda(x, g, pad)
        torch.cuda.synchronize()
        if fold_conv.launch_counts["channel_conv3d_wgrad"] != before + 2:
            raise AssertionError("channel_conv3d_wgrad counts one launch a call")
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            raise AssertionError(f"channel_conv3d_wgrad {label}: two calls, other bits")
        want_w, want_b = fold_conv.channel_conv3d_wgrad_plain(x.double(), g.double(), pad)
        errs = []
        for got, want in ((dw, want_w), (db, want_b)):
            if x.dtype == torch.bfloat16:
                spacing = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
                errs.append(((got.double() - want).abs() / spacing).max().item())
            else:
                errs.append(((got.double() - want).abs().max() / want.abs().max()).item())
        log(f"channel_conv3d_wgrad {label} {str(x.dtype)[6:]}: dW {errs[0]:.3e}, db "
            f"{errs[1]:.3e} " + ("bfloat16 spacings (at most 1)" if x.dtype == torch.bfloat16
                                 else f"of the largest (tolerance {TOL_CONV3D_WGRAD:g})"))
        if max(errs) > (1.0 if x.dtype == torch.bfloat16 else TOL_CONV3D_WGRAD):
            raise AssertionError(f"channel_conv3d_wgrad {label} disagrees with its plain version")
        return max(errs)

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for b, cp, hin, w, d, ph, dt in CONV3D_WGRAD_CASES:
        err = check(f"B={b} Cp={cp} Hin={hin} W={w} d={d} pad=(1,{ph},1)",
                    *inputs(b, cp, hin, w, d, ph, dt))
        worst[dt] = max(worst[dt], err)
    by_shape = []
    for name, b, cp, h, w, d, dt in CONV3D_WGRAD_SHAPES:
        x, g, pad = inputs(b, cp, h, w, d, 1, dt)
        worst[dt] = max(worst[dt], check(name, x, g, pad))
        k = time_ms(lambda: fold_conv.channel_conv3d_wgrad_cuda(x, g, pad))
        p = time_ms(lambda: fold_conv.channel_conv3d_wgrad_plain(x, g, pad), **PLAIN_REPS)
        lib = time_ms(lambda: torch.nn.grad.conv3d_weight(x, (d, 1, 3, 3, 3), g, padding=1))
        voxels = b * cp * h * w
        n_bytes = voxels * (1 + d) * x.element_size()
        times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
                 "operations": voxels * d * (2 * 27 + 1) / PEAK_FP32_OPS * 1e3,
                 "launch": _launch_floor_ms[0]}
        by = max(times, key=times.get)
        row = dict(shape=name, b=b, cp=cp, h=h, w=w, d=d, dtype=dt, ms=k, plain_ms=p,
                   library_ms=lib, bound_ms=times[by], bound_by=by,
                   bytes_bound_ms=times["bytes"], over_bytes_bound=k / times["bytes"])
        by_shape.append(row)
        log(f"channel_conv3d_wgrad {name} [{b},{d},{cp},{h},{w}] {dt}: kernel {k:.4f} ms, "
            f"bound {times[by]:.4f} ({by}; bytes {times['bytes']:.4f}, {k / times['bytes']:.2f}x), "
            f"plain {p:.3f}, torch.nn.grad.conv3d_weight {lib:.4f}")
    first = by_shape[0]
    return {"channel_conv3d_wgrad": dict(
        max_abs_err=worst["float32"], max_bf16_spacings=worst["bfloat16"], ms=first["ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=first["library_ms"], dtype="float32 and bfloat16", by_shape=by_shape)}


def flagship_view_synthesis(model, batch, device, dtype):
    """view_synthesis through the warp kernels vs the plain version, value
    and d coords, on the first step's real depths and poses at every scale,
    the images in the compute dtype (the model's state is untouched:
    GroupNorm keeps no statistics)."""
    import torch

    from packnet_sfm_tpu_torch.engine.train import prepare_train_batch
    from packnet_sfm_tpu_torch.geometry.camera import (
        Camera, project, reconstruct, scale_intrinsics)
    from packnet_sfm_tpu_torch.losses.photometric import inv2depth
    from packnet_sfm_tpu_torch.models.sfm import model_forward
    from packnet_sfm_tpu_torch.ops import warp
    from packnet_sfm_tpu_torch.ops.image import interpolate_image

    worst_out, worst_rel = 0.0, 0.0
    b = prepared(batch, device, dtype)
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
            plain = warp.grid_sample_plain(ref_s.float(), cp)
            (kern * grad).sum().backward()
            (plain * grad).sum().backward()
            if not (torch.isfinite(kern).all() and torch.isfinite(ck.grad).all()):
                raise AssertionError("non-finite view synthesis")
            worst_out = max(worst_out, (kern - plain).abs().max().item())
            worst_rel = max(worst_rel, (ck.grad - cp.grad).abs().max().item()
                            / cp.grad.abs().max().item())
    log(f"view_synthesis on the first step's depths and poses, 4 scales x 2 contexts, "
        f"{dtype_name(dtype)} images: kernel "
        f"vs plain max |d out| {worst_out:.3e} (tolerance {TOL_WARP_FWD:g}), d coords "
        f"{worst_rel:.3e} of the largest (tolerance {TOL_WARP_GRAD:g})")
    if not (worst_out <= TOL_WARP_FWD and worst_rel <= TOL_WARP_GRAD):
        raise AssertionError("view_synthesis through the kernels disagrees with plain")


def flagship_cpu_reference(model, cfg, device, dtype):
    """model_loss at 64x96, batch 2, on the card (kernels) and on the CPU
    (plain version) with the same weights, jitter and flip draw, in the
    model's compute dtype."""
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
    cpu_model = setup_model(cfg.model, device="cpu", dtype=dtype)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    losses = {}
    for name, m, dev in (("card", model, device), ("cpu", cpu_model, "cpu")):
        gen = torch.Generator().manual_seed(0)      # first draw 0.4963 < 0.5: flipped
        with torch.no_grad():
            losses[name] = model_loss(m, prepared(batch, dev, dtype), generator=gen)[0].item()
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    tol = TOL_LOSS_CPU if dtype is None else TOL_LOSS_CPU_BF16
    log(f"model_loss 64x96 batch 2, flipped, {dtype_name(dtype)}: card {losses['card']:.7f} "
        f"cpu {losses['cpu']:.7f} rel {rel:.2e} (tolerance {tol:g})")
    if not rel <= tol:
        raise AssertionError("model_loss on the card disagrees with the CPU")
    return rel


def flagship_phase(device, cfg):
    """Phase 4: the flagship step as its config says (bfloat16), then in
    float32 beside it. Returns {dtype: the steps' numbers}."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.datasets.augmentations import draw_jitter_params
    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset, collate_train_batch
    from packnet_sfm_tpu_torch.engine.factory import compute_dtype, make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics

    H, W = cfg.datasets.augmentation.image_shape
    bs = cfg.datasets.train.batch_size
    loss = cfg.model.loss
    dtype = compute_dtype(cfg)
    log(f"config: {cfg.model.name}, {cfg.model.depth_net.name}-{cfg.model.depth_net.version} "
        f"+ {cfg.model.pose_net.name}, {H}x{W}, batch {bs}, {loss.num_scales} scales, "
        f"automask {loss.automask_loss}, reduce {loss.photometric_reduce_op}, flip_lr_prob "
        f"{loss.flip_lr_prob}, jitter {tuple(cfg.datasets.augmentation.jittering)}, arch.dtype "
        f"{cfg.arch.dtype}; then {STEPS} float32 steps")
    ds = SyntheticSfmDataset(length=STEPS * bs, height=H, width=W, seed=0)
    rng = np.random.default_rng(0)
    batches = []
    for i in range(STEPS):
        samples = [ds[i * bs + j] for j in range(bs)]
        jitter = [draw_jitter_params(cfg.datasets.augmentation.jittering, rng) for _ in samples]
        batches.append(collate_train_batch(samples, jitter))

    result = {}
    for dt in (dtype, None):
        t0 = time.perf_counter()
        model = setup_model(cfg.model, device=device, seed=0, dtype=dt)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"model built in {time.perf_counter() - t0:.1f} s, {n_params / 1e6:.1f} M "
            f"parameters, computing in {dtype_name(dt)}")
        optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                              steps_per_epoch=STEPS)
        step = make_train_step(model, optimizer, scheduler, num_scales=loss.num_scales,
                               generator=torch.Generator().manual_seed(0),
                               compute_dtype=dt or torch.float32)
        flagship_view_synthesis(model, batches[0], device, dt)
        rel = flagship_cpu_reference(model, cfg, device, dt)

        log(f"flagship train steps, {dtype_name(dt)}:")
        counts, stats = run_steps(step, zero_metrics(device), batches, 0.0)
        # the contexts are stacked on the batch: one warp per scale and step,
        # through the variant of the images' dtype
        suffix = "" if dt is None else "_bf16"
        want = {key: 0 for key in counts}
        want.update({"warp_fwd" + suffix: KITTI_SCALES * STEPS,
                     "warp_bwd" + suffix: KITTI_SCALES * STEPS})
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        result[dtype_name(dt)] = dict(stats, launches=counts, cpu_loss_rel=rel)
        del model, optimizer, scheduler, step
        torch.cuda.empty_cache()
    return result


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
    return diff, table_lists(table), path


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
    result["protocol_max_abs_diff"], result["table"], ckpt = eval_protocol(model, cfg, step,
                                                                          out_dir)

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

    result["half"] = eval_half(device, cfg, model, metrics_cfg, ckpt, result["table"], rgb)

    result["launches"] = read_counts()
    log(f"launches during eval and infer: {result['launches']}")
    if any(result["launches"].values()):
        raise AssertionError("the eval path launched a kernel of the port")
    return result


def eval_half(device, cfg, model32, metrics_cfg, ckpt, table32, rgb):
    """Eval and infer ``--half``: the same weights built with the bfloat16
    compute dtype, the eval step timed at B = 1 and 4; ``cli.eval.evaluate``
    with ``half=True`` on the saved checkpoint against the float32 run's
    table; infer's depth-only forward of the bfloat16 model against its eval
    step's straight half."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.cli.eval import evaluate
    from packnet_sfm_tpu_torch.cli.infer import make_depth_fn
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, eval_forward, make_eval_step

    log("eval --half: the same weights, computing in bfloat16")
    model = setup_model(cfg.model, device=device, dtype=torch.bfloat16)
    model.load_state_dict(model32.state_dict())
    step = make_eval_step(model, metrics_cfg)
    result = {f"B{b}": time_eval_steps(step, eval_batches(cfg, b, EVAL_GT)) for b in (1, 4)}

    t0 = time.perf_counter()
    table = evaluate(ckpt, half=True)[0]
    secs = time.perf_counter() - t0
    rel = {m: float(abs(table[m][0] - table32[m][0]) / abs(table32[m][0])) for m in EVAL_MODES}
    log(f"cli.eval.evaluate(half=True) took {secs:.1f} s; abs_rel against the float32 run, "
        "relative: " + ", ".join(f"{m} {table[m][0]:.5f} vs {table32[m][0]:.5f} ({rel[m]:.2e})"
                                 for m in EVAL_MODES) + f" (tolerance {TOL_HALF_ABS_REL:g})")
    if not (max(rel.values()) <= TOL_HALF_ABS_REL
            and all(np.all(np.isfinite(table[m])) for m in EVAL_MODES)):
        raise AssertionError("eval --half disagrees with the float32 eval")

    depth_fn = make_depth_fn(model)
    ms = []
    for _ in range(EVAL_STEPS + 1):
        t0 = time.perf_counter()
        inv = depth_fn(rgb)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    straight = eval_forward(model, rgb)[:1]
    infer_rel = ((inv - straight).abs().max() / straight.abs().max()).item()
    med = statistics.median(ms[1:])
    log(f"infer --half depth-only forward: median of calls 2-{len(ms)} {med:.2f} ms, "
        f"{1e3 / med:.2f} images/s; against the bfloat16 eval step's straight half "
        f"{infer_rel:.3e} of the largest inverse depth (tolerance {TOL_INFER_HALF:g})")
    if not (inv.dtype == torch.float32 and infer_rel <= TOL_INFER_HALF
            and torch.isfinite(inv).all()):
        raise AssertionError("infer --half disagrees with the bfloat16 eval step")
    del model, step
    torch.cuda.empty_cache()
    return dict(result, abs_rel_rel_err=rel, table=table_lists(table), evaluate_seconds=secs,
                infer_ms=med, infer_images_per_s=1e3 / med, infer_rel_err=infer_rel)


def table_lists(table):
    return {m: [float(x) for x in v] for m, v in table.items()}


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
    counts = read_counts()
    steps = trainer.step
    want = {k: 0 for k in counts}
    want.update(warp_fwd=TRAIN_SCALES * steps, warp_bwd=TRAIN_SCALES * steps)
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


# Phase 7: trees in the releases' own layouts and at their resolutions,
# written under build/chip_smoke_data/. Frames are a smooth scene panning a
# few pixels a frame, with mild noise (sigma 2 levels), so that they
# compress and decode like photographs. KITTI raw, the layout of the JAX
# tests' fixture (tests/test_datasets.py): drives at eigen_test's three
# native sizes (two 375x1242 drives, one 376x1241, one 370x1226), each under
# its date's calibration, PNG frames, OXTS packets and velodyne depth npz
# with VELODYNE_DENSITY of the pixels valid. The train split takes frames
# 1..KITTI_TRAIN of each drive (both neighbours exist), the two validation
# splits frames 10-11 and 14-15, the test split every frame.
KITTI_DRIVES = (("2011_09_26", 1, (375, 1242)), ("2011_09_26", 2, (375, 1242)),
                ("2011_10_03", 27, (376, 1241)), ("2011_09_30", 16, (370, 1226)))
KITTI_CALIB = {"2011_09_26": (721.5377, 609.5593, 172.854),
               "2011_10_03": (718.856, 607.1928, 185.2157),
               "2011_09_30": (707.0912, 601.8873, 183.1104)}
KITTI_FRAMES, KITTI_TRAIN = 20, 6
VELODYNE_DENSITY = 0.04
# proj_depth/groundtruth (16-bit PNGs, depth * 256): the same depth, denser,
# as KITTI's accumulated ground truth is; its own generator, so that the
# velodyne maps and frames of phase 7 stay what they were
GROUNDTRUTH_DENSITY = 0.16
# The image folder: numbered JPEG frames at a source size above the
# config's 384x384 (the omnicam release's own size is not in the repository).
OMNICAM_SIZE, OMNICAM_FRAMES = (768, 768), 12
# One DGP scene in the JAX tests' schema (tests/test_ddad.py) at DDAD's
# 1936x1216, JPEG frames, channels named as train_ddad.yaml names them
# ('camera_01', a second camera 'camera_05', 'lidar'), a cloud of
# DDAD_POINTS points a sample.
DDAD_SIZE, DDAD_FRAMES, DDAD_POINTS = (1216, 1936), 6, 100_000
DECODE_REPS = 10
# Per train step, as the configs run (bfloat16): the flagship's warp at 4
# scales, NRS's one scale with its two projections.
FLAGSHIP_LAUNCHES = {"warp_fwd_bf16": KITTI_SCALES, "warp_bwd_bf16": KITTI_SCALES}
NRS_LAUNCHES = {"softargmax_fwd": 2, "softargmax_bwd": 2, "warp_fwd_bf16": 2,
                "warp_bwd_bf16": 2}


def photo_frames(rng, n, h, w, shift=3):
    """``n`` uint8 frames [h, w, 3] of one smooth scene, panning ``shift`` px
    a frame, with mild noise."""
    import numpy as np
    from PIL import Image

    wide = w + shift * n

    def octave(cell, lo, hi):
        grid = rng.integers(lo, hi, size=(h // cell + 2, wide // cell + 2, 3), dtype=np.uint8)
        return np.asarray(Image.fromarray(grid).resize((wide, h), Image.BICUBIC), np.float32)
    scene = octave(48, 30, 225) + octave(8, 108, 148) - 128
    for i in range(n):
        frame = scene[:, shift * i:shift * i + w] + rng.normal(0, 2, size=(h, w, 3))
        yield np.clip(frame, 0, 255).astype(np.uint8)


def write_images(jobs):
    """Write (path, uint8 array) pairs in threads (PNG or JPEG by suffix)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def write(job):
        path, arr = job
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).save(path, quality=90)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def write_kitti_tree(root):
    """The KITTI raw tree of phase 7; returns its split files by name."""
    import numpy as np

    rng, rng_gt = np.random.default_rng(7), np.random.default_rng(17)
    R = ("9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 "
         "-4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01")
    splits = {"train": [], "val": [], "test_a": [], "test": []}
    jobs = []
    for date, num, (h, w) in KITTI_DRIVES:
        fx, cx, cy = KITTI_CALIB[date]
        P = f"{fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0"
        (root / date).mkdir(parents=True, exist_ok=True)
        (root / date / "calib_cam_to_cam.txt").write_text(
            f"P_rect_02: {P}\nP_rect_03: {P}\nR_rect_00: {R}\n")
        (root / date / "calib_velo_to_cam.txt").write_text(
            f"R: {R}\nT: -4.069766e-03 -7.631618e-02 -2.717806e-01\n")
        (root / date / "calib_imu_to_velo.txt").write_text(
            f"R: {R}\nT: -8.086759e-01 3.195559e-01 -7.997231e-01\n")
        drive = root / date / f"{date}_drive_{num:04d}_sync"
        ys, xs = np.mgrid[:h, :w].astype(np.float32)
        depth = 5.0 + 70.0 * (1.0 - ys / h) ** 2 + 3.0 * np.sin(xs / 97.0)
        for d in ("oxts/data", "proj_depth/velodyne/image_02", "proj_depth/groundtruth/image_02"):
            (drive / d).mkdir(parents=True)
        for i, frame in enumerate(photo_frames(rng, KITTI_FRAMES, h, w)):
            rel = f"{date}/{drive.name}/image_02/data/{i:010d}.png"
            jobs.append((root / rel, frame))
            packet = [49.0 + i * 1e-5, 8.43 + i * 2e-5, 110.0 + 0.01 * i, 0.001 * i, 0.02,
                      0.5 + 0.001 * i] + [0.0] * 24
            np.savetxt(drive / "oxts/data" / f"{i:010d}.txt", [packet], delimiter=" ")
            valid = rng.uniform(size=(h, w)) < VELODYNE_DENSITY
            np.savez_compressed(drive / "proj_depth/velodyne/image_02" / f"{i:010d}.npz",
                                velodyne_depth=(depth * valid).astype(np.float32))
            dense = rng_gt.uniform(size=(h, w)) < GROUNDTRUTH_DENSITY
            jobs.append((drive / "proj_depth/groundtruth/image_02" / f"{i:010d}.png",
                         np.round(depth * dense * 256.0).astype(np.uint16)))
            splits["test"].append(rel)
            if 1 <= i <= KITTI_TRAIN:
                splits["train"].append(rel)
            if i in (10, 11):
                splits["val"].append(rel)
            if i in (14, 15):
                splits["test_a"].append(rel)
    write_images(jobs)
    for name, lines in splits.items():
        (root / f"{name}.txt").write_text("".join(f"{x}\n" for x in lines))
    return root


def write_frame_folder(root):
    import numpy as np

    rng = np.random.default_rng(8)
    write_images([(root / f"{i:06d}.jpg", frame) for i, frame in
                  enumerate(photo_frames(rng, OMNICAM_FRAMES, *OMNICAM_SIZE))])
    return root


def write_dgp_scene(root):
    """One DGP scene: per sample a JPEG of each camera with its pose, and a
    lidar cloud; calibration for the cameras and the lidar."""
    import numpy as np

    rng = np.random.default_rng(9)
    h, w = DDAD_SIZE
    scene = root / "000000"
    cams, lidar = ["camera_01", "camera_05"], "lidar"
    identity = {"translation": {"x": 0, "y": 0, "z": 0},
                "rotation": {"qw": 1, "qx": 0, "qy": 0, "qz": 0}}
    data, samples, jobs = [], [], []
    frames = {cam: list(photo_frames(rng, DDAD_FRAMES, h, w, shift=6)) for cam in cams}
    (scene / "point_cloud" / lidar).mkdir(parents=True)
    for k in range(DDAD_FRAMES):
        keys = []
        for cam in cams:
            fn = f"rgb/{cam}/{k:015d}.jpg"
            jobs.append((scene / fn, frames[cam][k]))
            data.append({"key": f"{cam}_{k}", "datum": {"image": {
                "channel": cam, "filename": fn,
                "pose": {"translation": {"x": 0.5 * k, "y": 0.0, "z": 0.0},
                         "rotation": {"qw": 1, "qx": 0, "qy": 0, "qz": 0}}}}})
            keys.append(f"{cam}_{k}")
        points = np.stack([rng.uniform(-40, 40, DDAD_POINTS), rng.uniform(-3, 12, DDAD_POINTS),
                           rng.uniform(2, 150, DDAD_POINTS)], -1).astype(np.float32)
        fn = f"point_cloud/{lidar}/{k:015d}.npz"
        np.savez_compressed(scene / fn, point_cloud=points)
        data.append({"key": f"{lidar}_{k}", "datum": {"point_cloud": {
            "channel": lidar, "filename": fn}}})
        samples.append({"datum_keys": keys + [f"{lidar}_{k}"]})
    write_images(jobs)
    (scene / "calibration").mkdir()
    (scene / "calibration" / "calib.json").write_text(json.dumps({
        "names": cams + [lidar],
        "intrinsics": [{"fx": 1000.0, "fy": 1000.0, "cx": w / 2, "cy": h / 2}] * 2 + [{}],
        "extrinsics": [identity] * 3}))
    (scene / "scene_000000.json").write_text(json.dumps({"data": data, "samples": samples}))
    return root


def decode_times(files):
    """Median ms of a decode to uint8 RGB, natively and with Pillow, of each
    named file."""
    import numpy as np
    from PIL import Image

    from packnet_sfm_tpu_torch import native

    def pillow(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    out = {}
    for name, path in files.items():
        row = {}
        for decoder, fn in (("native", native.decode_image), ("pillow", pillow)):
            if decoder == "native" and not native.native_available():
                row[decoder] = None
                continue
            fn(str(path))
            ms = []
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                fn(str(path))
                ms.append((time.perf_counter() - t0) * 1e3)
            row[decoder] = statistics.median(ms)
        out[name] = row
        native_ms = "not built" if row["native"] is None else f"{row['native']:.3f} ms"
        log(f"decode {name} to uint8 RGB: native {native_ms}, Pillow {row['pillow']:.3f} ms "
            f"(median of {DECODE_REPS})")
    return out


def read_counts():
    from packnet_sfm_tpu_torch.ops import softargmax as sa
    from packnet_sfm_tpu_torch.ops import warp

    return {**sa.launch_counts, **sa.band_launch_counts, **warp.launch_counts,
            **warp.bf16_launch_counts}


def reset_counts():
    from packnet_sfm_tpu_torch.ops import softargmax as sa
    from packnet_sfm_tpu_torch.ops import warp

    sa.reset_launch_counts()
    warp.reset_launch_counts()


def data_train_run(device, cfg, per_step, label, bare=True):
    """``cli.train``'s build_trainer and fit on ``cfg`` (a config dict),
    the launch counters read around the fit; then, with ``bare``, the train
    loader alone over an epoch and the bare step on that epoch's batches.
    Returns the run's numbers."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.cli.train import build_trainer
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES, METRIC_KEYS, zero_metrics
    from packnet_sfm_tpu_torch.models.batch_utils import stack_multicam_batch

    gc.collect()                    # an earlier run's trainer must not count in this one's peak
    torch.cuda.empty_cache()
    trainer = build_trainer(cfg, device=device)
    batch_images = []
    build = trainer._train_step_for

    def watched(num_scales):
        step = build(num_scales)

        def run(acc, batch, progress):
            batch_images.append(batch["rgb"].shape[0])
            return step(acc, batch, progress)
        return run
    trainer._train_step_for = watched
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**20
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    del trainer._train_step_for     # the wrapper, which holds the trainer in a cycle
    counts, steps = read_counts(), trainer.step
    want = {k: per_step.get(k, 0) * steps for k in counts}
    h = history[-1]
    log(f"{label}: fit of {steps} steps (images a step {sorted(set(batch_images))}) in "
        f"{fit_s:.1f} s: loss {h['loss']:.5f}, {h['imgs_per_sec']:.2f} imgs/s over "
        f"{h['seconds']:.2f} s of training, validation {h['val_seconds']:.2f} s, peak "
        f"{h['peak_mib']:.1f} MiB ({held:.1f} MiB allocated before the fit: the model); "
        f"launches {counts}")
    if counts != want or steps != trainer.steps_per_epoch * len(history):
        raise AssertionError(f"{label}: {steps} steps, launch counts {counts}, expected {want}")
    for e in history:
        tables = [np.array([v[m] for m in EVAL_MODES]) for v in e["val"]]
        if not (np.isfinite(e["loss"]) and all(np.all(np.isfinite(t)) for t in tables)):
            raise AssertionError(f"{label}: epoch {e['epoch']}: loss {e['loss']}, {tables}")
    rec = dict(steps=steps, images_per_step=sorted(set(batch_images)), loss=h["loss"],
               metrics={k: h[k] for k in METRIC_KEYS if k in h},
               depth_gt_abs_rel_by_epoch=[e["val"][0]["depth_gt"][0] if e["val"] else None
                                          for e in history],
               imgs_per_sec=h["imgs_per_sec"], train_seconds=h["seconds"],
               val_seconds=h["val_seconds"], peak_mib=h["peak_mib"], mib_before_fit=held,
               launches=counts,
               launches_per_step={k: v / steps for k, v in counts.items() if v},
               val=[{m: float(v[m][0]) for m in EVAL_MODES} for v in h["val"]])
    if not bare:
        return rec
    loader = trainer.train_loaders[0]
    t0 = time.perf_counter()
    batches = [stack_multicam_batch(b) for b in loader.epoch(0)]
    loader_s = time.perf_counter() - t0
    n_samples = sum(len(b["idx"]) for b in batches)
    (num_scales,) = trainer._train_steps
    step, acc, ms = build(num_scales), zero_metrics(device), []
    for b in batches:
        t0 = time.perf_counter()
        acc = step(acc, b, 0.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    bare_ms = statistics.median(ms[1:])
    images = batches[0]["rgb"].shape[0]
    rec.update(loader_samples_per_s=n_samples / loader_s, loader_seconds=loader_s,
               loader_threads=loader.num_workers, bare_step_ms=bare_ms,
               bare_images_per_s=images / bare_ms * 1e3,
               loop_share=h["imgs_per_sec"] / (images / bare_ms * 1e3))
    log(f"{label}: train loader alone {n_samples} samples in {loader_s:.2f} s "
        f"({rec['loader_samples_per_s']:.1f} samples/s, {loader.num_workers} threads); bare "
        f"step on its batches " + ", ".join(f"{x:.1f}" for x in ms)
        + f" ms, median of steps 2-{len(ms)} {bare_ms:.2f} ms ({rec['bare_images_per_s']:.1f} "
        f"images/s); the fit's epoch ran at {rec['loop_share']:.3f} of it")
    return rec


def kitti_data_run(device, root, out):
    """train_kitti.yaml on the KITTI tree, then eval_kitti.yaml on its
    checkpoint (B = 4 in shape buckets against B = 1), then infer."""
    import numpy as np

    from packnet_sfm_tpu_torch.cli.eval import evaluate
    from packnet_sfm_tpu_torch.cli.infer import infer_and_save
    from packnet_sfm_tpu_torch.core.config import config_from_dict
    from packnet_sfm_tpu_torch.datasets.loader import DataLoader, setup_dataset
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES

    cfg = kitti_train_config(root, {"filepath": str(out / "kitti_ckpt"), "save_top_k": 1})
    rec = data_train_run(device, cfg, FLAGSHIP_LAUNCHES, "KITTI train_kitti.yaml")
    (ckpt,) = sorted((out / "kitti_ckpt").iterdir())

    reset_counts()
    tables, secs = {}, {}
    for b in (4, 1):
        ecfg = kitti_eval_config(root, b)
        t0 = time.perf_counter()
        tables[b] = evaluate(str(ckpt), ecfg, device=device)[0]
        secs[b] = time.perf_counter() - t0
    parsed = config_from_dict(ecfg)
    ds = setup_dataset(parsed.datasets.test, "test", parsed.datasets.augmentation)[0]
    plan = DataLoader(ds, batch_size=4, shuffle=False, drop_last=False)._batch_plan(0)
    buckets = {}
    for idxs, pad in plan:
        shape = ds.sample_shape(int(idxs[0]))
        if any(ds.sample_shape(int(i)) != shape for i in idxs):
            raise AssertionError(f"a mixed batch: {idxs}")
        buckets[str(shape)] = buckets.get(str(shape), 0) + 1
    diff = max(float(np.abs(tables[4][m] - tables[1][m]).max()) for m in EVAL_MODES)
    log(f"KITTI eval_kitti.yaml on {len(ds)} samples: B=4 {secs[4]:.1f} s in {len(plan)} "
        f"batches by ground-truth size {buckets}, B=1 {secs[1]:.1f} s; max |table B=4 - "
        f"B=1| {diff:.3e} (tolerance {TOL_PROTOCOL:g}); depth_gt abs_rel "
        f"{tables[4]['depth_gt'][0]:.4f}")
    if len(buckets) != 3 or not diff <= TOL_PROTOCOL:
        raise AssertionError("eval on the KITTI tree: buckets or tables disagree")
    if not all(np.all(np.isfinite(t[m])) for t in tables.values() for m in EVAL_MODES):
        raise AssertionError(f"non-finite eval table: {tables}")

    frames = root / KITTI_DRIVES[0][0] / f"{KITTI_DRIVES[0][0]}_drive_{KITTI_DRIVES[0][1]:04d}_sync" \
        / "image_02" / "data"
    printed = io.StringIO()         # the CLI's line per image
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        infer_and_save(str(ckpt), str(frames), str(out / "infer"), save="npz", device=device)
    infer_s = time.perf_counter() - t0
    written = sorted((out / "infer").glob("*.npz"))
    depths = [np.load(p)["depth"] for p in written]
    counts = read_counts()
    log(f"KITTI infer on {len(written)} frames of {KITTI_DRIVES[0][2]}: {infer_s:.1f} s, model "
        f"build and restore included; launches during eval and infer {counts}")
    shape = tuple(config_from_dict(cfg).datasets.augmentation.image_shape)
    lines = printed.getvalue().splitlines()
    if len(written) != KITTI_FRAMES or len(lines) != KITTI_FRAMES or any(
            d.shape != shape or not np.all(np.isfinite(d)) for d in depths):
        raise AssertionError(f"infer outputs: {[d.shape for d in depths]}")
    if any(counts.values()):
        raise AssertionError("eval or infer launched a kernel of the port")
    rec.update(eval_samples=len(ds), eval_buckets=buckets, eval_seconds_b4=secs[4],
               eval_seconds_b1=secs[1], eval_b4_vs_b1_max_abs_diff=diff,
               eval_table_b4={m: [float(x) for x in tables[4][m]] for m in EVAL_MODES},
               infer_frames=len(written), infer_seconds=infer_s)
    return rec


def data_phase(device):
    """Phase 7 (see the module docstring); returns its numbers."""
    import copy
    import shutil

    from packnet_sfm_tpu_torch import native
    from packnet_sfm_tpu_torch.core.config import DDAD

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    kitti = write_kitti_tree(root / "KITTI_raw")
    omni = write_frame_folder(root / "omnicam")
    dgp = write_dgp_scene(root / "DDAD")
    log(f"phase 7 trees written in {time.perf_counter() - t0:.1f} s: KITTI raw "
        f"{len(KITTI_DRIVES)} drives x {KITTI_FRAMES} frames, an image folder of "
        f"{OMNICAM_FRAMES} frames at {OMNICAM_SIZE[0]}x{OMNICAM_SIZE[1]}, a DGP scene of "
        f"{DDAD_FRAMES} samples at {DDAD_SIZE[0]}x{DDAD_SIZE[1]} with {DDAD_POINTS} lidar points")
    which = native.decoder()
    log(f"image decoder in use: {which}"
        + ("" if which == "native" else f"; the native build failed: {native.build_error()}"))
    result = dict(decoder=which, native_build_error=native.build_error())
    first = kitti / "test.txt"
    result["decode_ms"] = decode_times({
        "kitti_375x1242_png": kitti / first.read_text().split()[0],
        "ddad_1216x1936_jpg": dgp / "000000" / "rgb" / "camera_01" / f"{0:015d}.jpg"})

    result["kitti"] = kitti_data_run(device, kitti, root)

    result["omnicam"] = data_train_run(device, omnicam_train_config(omni), NRS_LAUNCHES,
                                       "Image train_omnicam.yaml")

    cfg = copy.deepcopy(DDAD)
    cfg["arch"]["max_epochs"] = 1
    for split in ("train", "validation", "test"):
        cfg["datasets"][split]["path"] = [str(dgp)]
    result["ddad"] = data_train_run(device, cfg, FLAGSHIP_LAUNCHES, "DGP train_ddad.yaml")
    cfg["datasets"]["train"].update(cameras=[["camera_01", "camera_05"]], repeat=[1])
    cfg["datasets"]["validation"] = {"dataset": []}
    two = data_train_run(device, cfg, FLAGSHIP_LAUNCHES, "DGP train_ddad.yaml, two cameras",
                         bare=False)
    if two["images_per_step"] != [2 * cfg["datasets"]["train"]["batch_size"]]:
        raise AssertionError(f"two cameras: {two['images_per_step']} images a step")
    result["ddad_two_cameras"] = two
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 7 took {result['seconds']:.1f} s")
    return result


# Phase 8: multi-process training and evaluation. Two ranks share the one
# card over gloo where the machine has one (NCCL refuses two ranks on one
# card); NCCL with a card a rank where it has two or more.
DIST_TIMEOUT = 300
# the one-sided SIGTERM: phase 6's recipe at repeat [DRAIN_REPEAT], so that
# each of two ranks has 2 * DRAIN_REPEAT steps an epoch; rank 1 is signalled
# DRAIN_DELAY s after it printed its model
DRAIN_REPEAT, DRAIN_DELAY = 6, 1.5
# The first train_kitti.yaml step on two ranks of four rows against one rank
# on the eight: the mean of the ranks' losses relative, as the card against
# the CPU in bfloat16 (convolutions of another batch may take another
# algorithm), the gradient's cosine as phase 6's update cosine. Adam's first
# update is about lr * sign(g), and a bfloat16 weight gradient summed over
# two halves of 4 rows rounds otherwise than one over 8, so near-zero
# gradients flip sign: the update's cosine (TOL_UPDATE_COS) is held against
# one rank that takes the 8 rows as the two ranks split them (two halves,
# each with the flip the ranks draw, gradients averaged), and reported
# against one rank on the 8 rows at once.
TOL_DIST_LOSS = TOL_LOSS_CPU_BF16
WORLD1_STEPS = 12


def torchrun(nproc, args, log_dir=None):
    """Start ``torch.distributed.run --standalone`` of ``nproc`` ranks on
    ``args`` in a session of its own (``finish`` kills it whole)."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc)]
    if log_dir is not None:
        cmd += ["--log-dir", str(log_dir), "--redirects", "3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(cmd + [str(a) for a in args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def finish(proc, label, timeout=DIST_TIMEOUT, check=True):
    """Wait for a launch; kill every process of it after ``timeout`` s.
    Its output goes to build/chip_smoke_dist/<label>.log; returns (rc, output)."""
    import os
    import signal

    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{label}: no end in {timeout} s\n{out[-3000:]}")
    (ROOT / "build" / "chip_smoke_dist" / f"{label}.log").write_text(out)
    if check and proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{out[-3000:]}")
    return proc.returncode, out


def dist_job(nproc, label, wait=True, **job):
    """``chip_smoke.py --worker`` on ``nproc`` ranks for one job; returns
    each rank's result, or, without ``wait``, a function that waits for
    them (the job runs meanwhile)."""
    root = ROOT / "build" / "chip_smoke_dist"
    path = root / f"{label}.json"
    path.write_text(json.dumps(dict(job, out=str(root), label=label)))
    t0 = time.perf_counter()
    proc = torchrun(nproc, [ROOT / "chip_smoke.py", "--worker", path])

    def results():
        finish(proc, label)
        log(f"{label}: {nproc} ranks in {time.perf_counter() - t0:.1f} s")
        return [json.loads((root / f"{label}_rank{r}.json").read_text()) for r in range(nproc)]

    return results() if wait else results


def rank_logs(log_dir):
    return {int(p.parent.name): p.read_text() for p in log_dir.rglob("stdout.log")}


def kitti_train_config(root, checkpoint=None):
    """configs/train_kitti.yaml as written, on phase 7's KITTI tree, one
    epoch (its repeat [2]: 12 steps on one rank)."""
    import copy

    from packnet_sfm_tpu_torch.core.config import KITTI

    cfg = copy.deepcopy(KITTI)
    cfg["arch"]["max_epochs"] = 1
    cfg["checkpoint"] = checkpoint or {}
    cfg["datasets"]["train"].update(path=[str(root)], split=["train.txt"])
    cfg["datasets"]["validation"].update(path=[str(root)], split=["val.txt", "test_a.txt"])
    cfg["datasets"]["test"].update(path=[str(root)], split=["test.txt"])
    return cfg


def omnicam_train_config(folder):
    """configs/train_omnicam.yaml as written on phase 7's image folder, one
    epoch, its validation split dropped (it has no depth, and a fit
    validates each epoch)."""
    import copy

    from packnet_sfm_tpu_torch.core.config import OMNICAM

    cfg = copy.deepcopy(OMNICAM)
    cfg["arch"]["max_epochs"] = 1
    cfg["datasets"]["train"]["path"] = cfg["datasets"]["test"]["path"] = [str(folder)]
    cfg["datasets"]["validation"] = {"dataset": []}
    return cfg


def kitti_eval_config(root, batch_size=4):
    """configs/eval_kitti.yaml on phase 7's KITTI tree, writing nothing."""
    import copy

    from packnet_sfm_tpu_torch.core.config import EVAL_KITTI

    ecfg = copy.deepcopy(EVAL_KITTI)
    ecfg["datasets"]["test"].update(path=[str(root)], split=["test.txt"],
                                    batch_size=batch_size)
    ecfg["save"] = {"folder": ""}
    return ecfg


def first_kitti_step(device, rows=slice(0, 8), halves=False):
    """The first train_kitti.yaml step (bfloat16, flip drawn from arch.seed
    + 1 as the trainer draws it) on ``rows`` of the global batch of 8 noise
    frames at 192x640, or with ``halves`` on the 8 rows as two ranks of 4
    take them (each half with the same flip draw, gradients averaged, one
    Adam step): (loss, the weights' update and gradient flattened on the
    card, launch counts)."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict
    from packnet_sfm_tpu_torch.engine.factory import compute_dtype, make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import (
        cast_batch,
        make_train_step,
        prepare_train_batch,
        zero_metrics,
    )
    from packnet_sfm_tpu_torch.models.sfm import model_loss
    from packnet_sfm_tpu_torch.parallel.scaling import synthetic_batch

    cfg = config_from_dict(KITTI)
    dtype = compute_dtype(cfg)
    model = setup_model(cfg.model, device=device, seed=cfg.arch.seed, dtype=dtype)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 1000)
    batch = synthetic_batch(np.random.default_rng(8), 8, 192, 640)

    def take(part):
        return {k: [c[part] for c in v] if isinstance(v, list) else v[part]
                for k, v in batch.items()}
    before = torch.cat([p.detach().flatten() for p in model.parameters()])
    reset_counts()
    if halves:
        losses = []
        for half in (slice(0, 4), slice(4, 8)):
            loss, _ = model_loss(model, cast_batch(prepare_train_batch(take(half), device), dtype),
                                 num_scales=KITTI_SCALES,
                                 generator=torch.Generator().manual_seed(cfg.arch.seed + 1))
            (loss.float() / 2).backward()
            losses.append(float(loss))
        optimizer.step()
        loss = statistics.mean(losses)
    else:
        step = make_train_step(model, optimizer, scheduler, KITTI_SCALES, compute_dtype=dtype,
                               generator=torch.Generator().manual_seed(cfg.arch.seed + 1))
        loss = float(step(zero_metrics(device), take(rows), 0.0)["loss"][0])
    counts = read_counts()
    update = torch.cat([p.detach().flatten() for p in model.parameters()]) - before
    grad = torch.cat([p.grad.flatten() for p in model.parameters()])
    return loss, update, grad, counts


def cosine(a, b):
    return float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))


def dist_worker(job_path):
    """One rank of a phase 8 job (``chip_smoke.py --worker <job.json>``,
    started by ``torch.distributed.run``); writes <label>_rank<r>.json."""
    import os

    import torch

    from packnet_sfm_tpu_torch.parallel import mesh

    job = json.loads(pathlib.Path(job_path).read_text())
    out, label, kind = pathlib.Path(job["out"]), job["label"], job["kind"]
    rank = int(os.environ.get("RANK", "0"))
    (out / f"{label}_rank{rank}.pid").write_text(str(os.getpid()))
    res = {"rank": rank}
    if kind == "hr_runs":
        # phases 11 and 12's runs of tools/hr_2dmesh.py's recipes, one after
        # the other in this process (in one process group where a launcher
        # made one), each from the same weights and batch
        from packnet_sfm_tpu_torch.tools import hr_2dmesh

        grouped = "RANK" in os.environ
        device = (mesh.init_distributed(job["backend"], job["device"]) if grouped
                  else torch.device(job["device"]))
        for label, argv, dtype, perturb in job["runs"]:
            path = out / f"{label}.json"
            args = hr_2dmesh.parse_args(argv + ["--out", str(path)])
            run = hr_2dmesh.run_steps(args, device,
                                      mesh.make_mesh_2d(args.space) if grouped else None,
                                      torch.bfloat16 if dtype == "bfloat16" else None, perturb)
            if rank == 0:
                path.write_text(json.dumps(run))
            gc.collect()
            torch.cuda.empty_cache()
        if grouped:
            mesh.shutdown()
        return 0
    if kind == "plain_step":
        # no process group: the step without DDP, in a process of its own
        from packnet_sfm_tpu_torch.parallel.scaling import time_steps

        dt = time_steps(None, torch.device("cuda"), 4, 192, 640, WORLD1_STEPS, 3)
        res.update(step_ms=dt / WORLD1_STEPS * 1e3)
        (out / f"{label}_rank{rank}.json").write_text(json.dumps(res))
        return 0
    if kind == "nccl_one_card":
        # NCCL with every rank on card 0: it should refuse at the first collective
        try:
            mesh.init_distributed("nccl", "cuda:0")
            t = torch.ones(1, device="cuda:0")
            torch.distributed.all_reduce(t)
            torch.cuda.synchronize()
            res.update(refused=False)
        except Exception as e:          # what NCCL says is the result
            res.update(refused=True, error=f"{type(e).__name__}: {e}")
        (out / f"{label}_rank{rank}.json").write_text(json.dumps(res))
        os._exit(0)                     # the failed communicator is not torn down
    device = mesh.init_distributed(job["backend"], job["device"])
    res.update(world=mesh.process_count(), backend=torch.distributed.get_backend(),
               device=str(device))
    if kind == "steps":
        from packnet_sfm_tpu_torch.cli.eval import evaluate
        from packnet_sfm_tpu_torch.cli.train import train

        world = mesh.process_count()
        per = 8 // world
        loss, update, grad, counts = first_kitti_step(device, slice(per * rank, per * (rank + 1)))
        if rank == 0:
            torch.save(dict(update=update.cpu(), grad=grad.cpu()), out / "kitti_step_2rank.pt")
        res["kitti_step"] = dict(loss=loss, launches=counts)
        del update, grad
        torch.cuda.empty_cache()
        reset_counts()
        trainer = train(job["omnicam"], distributed=True, device=job["device"],
                        backend=job["backend"])
        h = trainer.history[-1]
        res["omnicam"] = dict(steps=trainer.step, launches=read_counts(), loss=h["loss"],
                              imgs_per_sec=h["imgs_per_sec"], seconds=h["seconds"])
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        (table,) = evaluate(job["eval_ckpt"], job["eval_config"], device=job["device"])
        res["eval"] = dict(table={m: [float(x) for x in v] for m, v in table.items()},
                           seconds=time.perf_counter() - t0, launches=read_counts())
    elif kind == "posegraph":
        import numpy as np

        from packnet_sfm_tpu_torch.egomotion.posegraph import (
            PoseGraphConfig, optimize_pose_graph_sharded)

        g = np.load(job["graph"])
        edges = {k: torch.from_numpy(g[k]).to(device) for k in ("i", "j", "Z", "w")}
        T, scales, cost = optimize_pose_graph_sharded(torch.from_numpy(g["T_init"]).to(device),
                                                      edges, PoseGraphConfig())
        res.update(T=T.cpu().tolist(), scales=scales.cpu().tolist(), cost=float(cost))
    elif kind in ("drain", "resume"):
        from packnet_sfm_tpu_torch.cli.train import train

        reset_counts()
        trainer = train(job["file"], distributed=True, device=job["device"],
                        backend=job["backend"])
        res.update(steps=trainer.step, history=trainer.history, launches=read_counts(),
                   preempted=trainer._preempt_requested)
    (out / f"{label}_rank{rank}.json").write_text(json.dumps(res))
    mesh.shutdown()
    return 0


def drain_and_resume(cfg, steps_per_epoch, backend, device):
    """``cli.train.train(cfg, distributed=True)`` on two ranks, SIGTERM to
    rank 1 alone DRAIN_DELAY s after it printed its model; both must drain
    at one step of epoch 0 and rank 0 write preempt_epoch=00.ckpt, whose
    two-rank resume must finish the epoch. Returns the numbers."""
    import os
    import signal

    root = ROOT / "build" / "chip_smoke_dist"
    cfg = dict(cfg, arch=dict(cfg["arch"], preempt_sync_every=4))
    ckpt_dir = pathlib.Path(cfg["checkpoint"]["filepath"])
    job = root / "drain.json"
    job.write_text(json.dumps(dict(kind="drain", file=cfg, backend=backend, device=device,
                                   out=str(root), label="drain")))
    proc = torchrun(2, [ROOT / "chip_smoke.py", "--worker", job], log_dir=root / "drain_logs")
    deadline, signalled = time.time() + DIST_TIMEOUT, False
    while time.time() < deadline and proc.poll() is None:
        if "Initialized model" in rank_logs(root / "drain_logs").get(1, ""):
            time.sleep(DRAIN_DELAY)
            os.kill(int((root / "drain_rank1.pid").read_text()), signal.SIGTERM)
            signalled = True
            break
        time.sleep(0.1)
    finish(proc, "drain", timeout=max(deadline - time.time(), 1))
    drained = [json.loads((root / f"drain_rank{r}.json").read_text()) for r in range(2)]
    ckpts = sorted(p.name for p in ckpt_dir.iterdir())
    log(f"SIGTERM to rank 1 alone: both ranks drained at steps {[d['steps'] for d in drained]} "
        f"of {steps_per_epoch}, preempted {[d['preempted'] for d in drained]}; checkpoints "
        f"{ckpts}")
    if not (signalled and drained[0]["steps"] == drained[1]["steps"] < steps_per_epoch
            and all(d["preempted"] for d in drained) and ckpts == ["preempt_epoch=00.ckpt"]):
        raise AssertionError(f"the drain: {drained}, {ckpts}")
    resumed = dist_job(2, "resume", kind="resume", file=str(ckpt_dir / ckpts[0]),
                       backend=backend, device=device)
    ckpts = sorted(p.name for p in ckpt_dir.iterdir())
    hist = [r["history"] for r in resumed]
    log(f"resume on 2 ranks: epochs {[[e['epoch'] for e in h] for h in hist]}, steps "
        f"{[r['steps'] for r in resumed]}, loss {hist[0][-1]['loss']:.5f}; checkpoints {ckpts}")
    if not (all([e["epoch"] for e in h] == [0] for h in hist)
            and all(r["steps"] == drained[0]["steps"] + steps_per_epoch for r in resumed)
            and any(c.startswith("epoch=00_") for c in ckpts)):
        raise AssertionError(f"the resume: {resumed}")
    return dict(steps=[d["steps"] for d in drained], of=steps_per_epoch,
                launches=[d["launches"] for d in drained],
                resume_steps=[r["steps"] for r in resumed], resume_loss=hist[0][-1]["loss"],
                resume_launches=[r["launches"] for r in resumed])


def distributed_phase(device, data):
    """Phase 8 (see the module docstring); returns its numbers."""
    import shutil

    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.parallel.scaling import measure_scaling

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    trees = ROOT / "build" / "chip_smoke_data"
    kitti_root, omni = trees / "KITTI_raw", trees / "omnicam"
    cards = torch.cuda.device_count()
    backend, two_device = ("nccl", "cuda") if cards >= 2 else ("gloo", "cuda:0")
    ranks_per_card = 1 if cards >= 2 else 2
    result = dict(cards=cards, backend=backend, ranks_per_card=ranks_per_card,
                  note=("two ranks on one card over gloo: correctness runs, not speed figures"
                        if ranks_per_card > 1 else "one card a rank over NCCL"))
    log(f"phase 8: {cards} card(s): two ranks over {backend}, {ranks_per_card} a card")

    # 3 first: NCCL with two ranks on one card, beside the world-1 run below
    # (its own launch and port; it fails at its first collective)
    nccl_refusal = (dist_job(2, "nccl_one_card", wait=False, kind="nccl_one_card")
                    if ranks_per_card > 1 else None)

    # 1. world 1 over NCCL through the CLI: phase 7's train_kitti.yaml run again
    cfg = kitti_train_config(kitti_root)
    try:
        import yaml  # noqa: F401 (the CLI reads the config with it)

        path = root / "train_kitti.yaml"
        path.write_text(json.dumps(cfg))           # JSON is YAML
        t0 = time.perf_counter()
        _, out = finish(torchrun(1, ["-m", "packnet_sfm_tpu_torch.cli.train", path,
                                     "--distributed"]), "world1_cli")
        history = json.loads(out.strip().splitlines()[-1])["history"]
        entry = "python -m torch.distributed.run --standalone --nproc_per_node 1 " \
                "-m packnet_sfm_tpu_torch.cli.train train_kitti.yaml --distributed"
    except ImportError:
        t0 = time.perf_counter()
        (res,) = dist_job(1, "world1_train", kind="drain", file=cfg, backend=None,
                          device="cuda")
        history, entry = res["history"], "cli.train.train(config, distributed=True), 1 rank"
    world1_s = time.perf_counter() - t0
    h, ref = history[-1], data["kitti"]
    loss_rel = abs(h["loss"] - ref["loss"]) / abs(ref["loss"])
    table_diff = max(abs(v["depth_gt"][0] - r["depth_gt"]) for v, r in zip(h["val"], ref["val"]))
    log(f"world 1 over NCCL ({entry}): {world1_s:.1f} s; loss {h['loss']:.6f} against phase 7's "
        f"{ref['loss']:.6f} without --distributed (rel {loss_rel:.2e}, tolerance "
        f"{TOL_RESUME_LOSS:g}); depth_gt abs_rel differs by {table_diff:.2e} (tolerance "
        f"{TOL_PROTOCOL:g}); {h['imgs_per_sec']:.2f} imgs/s over the epoch (phase 7: "
        f"{ref['imgs_per_sec']:.2f})")
    if not (loss_rel <= TOL_RESUME_LOSS and table_diff <= TOL_PROTOCOL):
        raise AssertionError("world 1 over NCCL differs from the run without --distributed")
    result["world1_cli"] = dict(entry=entry, seconds=world1_s, loss=h["loss"],
                                loss_rel_to_plain=loss_rel, val_abs_rel_diff=table_diff,
                                imgs_per_sec=h["imgs_per_sec"],
                                plain_imgs_per_sec=ref["imgs_per_sec"])

    # 2. the step plain and with DDP over NCCL at world 1 (parallel/scaling.py),
    # each in a fresh process: plain, then DDP
    plain, ddp, scaling = [], [], None
    for turn in ("plain", "ddp"):
        if turn == "plain":
            job = root / "plain_step.json"
            job.write_text(json.dumps(dict(kind="plain_step", out=str(root), label="plain_step")))
            finish(subprocess.Popen([sys.executable, ROOT / "chip_smoke.py", "--worker", job],
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, start_new_session=True), "plain_step")
            plain.append(json.loads((root / "plain_step_rank0.json").read_text())["step_ms"])
        else:
            scaling = measure_scaling(per_rank_batch=4, steps=WORLD1_STEPS, warmup=3,
                                      timeout=DIST_TIMEOUT)
            ddp.append(scaling[0]["step_ms"])
    ratio = statistics.mean(ddp) / statistics.mean(plain)
    log(f"train_kitti.yaml step at batch 4, 192x640, bfloat16, {WORLD1_STEPS} steps after 3, "
        f"each in a fresh process: plain {plain[0]:.2f} ms, DDP over NCCL at world 1 "
        f"{ddp[0]:.2f} ms (DDP / plain {ratio:.3f}); scaling at the "
        f"world sizes this machine has cards for: {scaling}")
    result["world1_step"] = dict(plain_ms=plain, ddp_ms=ddp, ddp_over_plain=ratio,
                                 steps=WORLD1_STEPS)
    result["scaling"] = scaling

    # 3. NCCL with two ranks on one card (started with 1)
    if nccl_refusal is not None:
        refused = nccl_refusal()
        errors = [r.get("error", "") for r in refused]
        said = " | ".join(e.splitlines()[-1] if e else "" for e in errors)
        log(f"NCCL, two ranks on card 0: refused by {sum(r['refused'] for r in refused)} of 2: "
            f"{said}")
        if not all(r["refused"] for r in refused):
            raise AssertionError("NCCL took two ranks on one card")
        result["nccl_one_card"] = [e.split("Last error:")[-1].strip() for e in errors]

    # 4. two ranks: the first train_kitti.yaml step, train_omnicam.yaml, eval_kitti.yaml
    (ckpt,) = sorted((trees / "kitti_ckpt").iterdir())
    gc.collect()
    torch.cuda.empty_cache()
    ranks = dist_job(2, "two_ranks", kind="steps", backend=backend, device=two_device,
                     omnicam=omnicam_train_config(omni), eval_ckpt=str(ckpt),
                     eval_config=kitti_eval_config(kitti_root))
    two = {k: v.to(device) for k, v in torch.load(root / "kitti_step_2rank.pt").items()}
    (root / "kitti_step_2rank.pt").unlink()
    loss1, update1, grad1, counts1 = first_kitti_step(device)
    cos_whole, grad_cos = cosine(update1, two["update"]), cosine(grad1, two["grad"])
    del update1, grad1
    loss_h, update_h, grad_h, _ = first_kitti_step(device, halves=True)
    cos, grad_cos_h = cosine(update_h, two["update"]), cosine(grad_h, two["grad"])
    del update_h, grad_h, two
    torch.cuda.empty_cache()
    loss2 = statistics.mean(r["kitti_step"]["loss"] for r in ranks)
    loss_rel = abs(loss2 - loss1) / abs(loss1)
    step_counts = [r["kitti_step"]["launches"] for r in ranks]
    log(f"train_kitti.yaml first step, 2 ranks x 4 rows against 1 rank x 8: loss {loss2:.6f} "
        f"against {loss1:.6f} (rel {loss_rel:.2e}, tolerance {TOL_DIST_LOSS:g}), gradient "
        f"cosine {grad_cos:.6f} (at least {TOL_UPDATE_COS}), update cosine {cos_whole:.6f}; "
        f"against 1 rank taking the 8 rows in the ranks' two halves: loss {loss_h:.6f}, "
        f"gradient cosine {grad_cos_h:.6f}, update cosine {cos:.6f} (both at least "
        f"{TOL_UPDATE_COS}); launches by rank {step_counts}, one rank {counts1}")
    if not (loss_rel <= TOL_DIST_LOSS and min(grad_cos, grad_cos_h, cos) >= TOL_UPDATE_COS):
        raise AssertionError("two ranks' first kitti step differs from one rank's")
    if any(c != {k: FLAGSHIP_LAUNCHES.get(k, 0) for k in c} for c in step_counts + [counts1]):
        raise AssertionError(f"kitti step launches: {step_counts}, {counts1}")
    omni_runs = [r["omnicam"] for r in ranks]
    for r in omni_runs:
        want = {k: NRS_LAUNCHES.get(k, 0) * r["steps"] for k in r["launches"]}
        if r["launches"] != want or not np.isfinite(r["loss"]) or r["steps"] < 1:
            raise AssertionError(f"omnicam on two ranks: {omni_runs}")
    log(f"train_omnicam.yaml on 2 ranks: steps {[r['steps'] for r in omni_runs]}, loss "
        f"{omni_runs[0]['loss']:.5f} (every rank: {[r['loss'] for r in omni_runs]}), launches by "
        f"rank {[r['launches'] for r in omni_runs]}")
    if len({r["loss"] for r in omni_runs}) != 1:
        raise AssertionError("the ranks' epoch losses differ: the metric sums were not reduced")
    tables = [r["eval"]["table"] for r in ranks]
    one = data["kitti"]["eval_table_b4"]
    diff = max(abs(a - b) for t in tables for m in one for a, b in zip(t[m], one[m]))
    log(f"eval_kitti.yaml on 2 ranks: {ranks[0]['eval']['seconds']:.1f} s; max |table - 1 rank's "
        f"(phase 7, B=4)| {diff:.3e} (tolerance {TOL_PROTOCOL:g}); launches "
        f"{[r['eval']['launches'] for r in ranks]}")
    if not diff <= TOL_PROTOCOL or any(any(r["eval"]["launches"].values()) for r in ranks):
        raise AssertionError("eval on two ranks differs from one rank")
    result["two_ranks"] = dict(
        kitti_first_step=dict(loss_2rank=loss2, loss_1rank=loss1, loss_rel=loss_rel,
                              grad_cosine=grad_cos, update_cosine_1rank_whole=cos_whole,
                              loss_1rank_halves=loss_h, grad_cosine_1rank_halves=grad_cos_h,
                              update_cosine=cos, launches=step_counts),
        omnicam=omni_runs, eval=dict(max_abs_diff_to_1rank=diff,
                                     seconds=ranks[0]["eval"]["seconds"],
                                     launches=[r["eval"]["launches"] for r in ranks]))

    # 5. the one-sided SIGTERM, the drain and a two-rank resume
    cfg = train_config(root / "drain_ckpt", max_epochs=1)
    cfg["datasets"]["train"]["repeat"] = [DRAIN_REPEAT]
    result["drain"] = drain_and_resume(cfg, 2 * DRAIN_REPEAT, backend, two_device)
    shutil.rmtree(root / "drain_ckpt", ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 8 took {result['seconds']:.1f} s")
    return result


# Phase 9: the remaining networks and model kinds, on phase 7's trees. Per
# train step, as each config runs: PackNet-SAN (supervised weight 1) has no
# photometric graph and launches no kernel of the port; overfit_kitti.yaml
# (float32) warps its 4 scales with the float32-image kernels; VelSup on
# train_kitti.yaml's networks (bfloat16) with the bfloat16-image ones.
NO_LAUNCHES = {}
OVERFIT_KITTI_LAUNCHES = {"warp_fwd": KITTI_SCALES, "warp_bwd": KITTI_SCALES}
# the supervised recipe's bar, as the JAX package's tests/test_overfit_bar.py
# pins it: epoch 1's depth_gt abs_rel below this, and below epoch 0's
SUPERVISED_BAR = 0.42
# SAN's model_loss on the card against the CPU: batch 1 at this size, ground
# truth on SAN_GT_DENSITY of the pixels and input depth on SAN_INPUT_DENSITY
SAN_CPU_HW = (64, 96)
SAN_GT_DENSITY, SAN_INPUT_DENSITY = 0.16, 0.04
# PackNet-SAN's 352x1216 KITTI crop in the form that both packages read: a
# 2-tuple (width, height) centred on each frame (the tree's frames are
# 370x1226 to 376x1241)
SAN_CROP = "(1216, 352)"


def san_kitti_config(root, checkpoint=None):
    """configs/train_packnet_san_kitti.yaml on phase 7's KITTI tree:
    groundtruth depth, velodyne input depth, batch 1, bfloat16, one epoch of
    its train split; as written but for its crop borders. Its (-352, 0.5,
    0.5, 1216) crops 188x621 of a 375x1242 frame as both packages read a
    4-tuple, (x1, y1, x2, y2) (ROADMAP.md §3 (q)); SAN_CROP is the 352x1216
    crop its authors meant, centred rather than the bottom rows."""
    import copy

    from packnet_sfm_tpu_torch.core.config import SAN_KITTI

    cfg = copy.deepcopy(SAN_KITTI)
    cfg["arch"]["max_epochs"] = 1
    cfg["datasets"]["augmentation"] = {"crop_train_borders": SAN_CROP,
                                       "crop_eval_borders": SAN_CROP}
    cfg["checkpoint"] = checkpoint or {}
    cfg["datasets"]["train"].update(path=[str(root)], split=["train.txt"])
    for split, files in (("validation", "val.txt"), ("test", "val.txt")):
        cfg["datasets"][split] = dict(cfg["datasets"][split], path=[str(root)], split=[files])
    return cfg


def san_batch(h: int, w: int):
    """A host batch of PackNet-SAN's train step: a Synthetic rgb [1, h, w,
    3], its depth at SAN_GT_DENSITY as 'depth' and at SAN_INPUT_DENSITY as
    'input_depth'."""
    import numpy as np

    from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticSfmDataset

    sample = SyntheticSfmDataset(length=1, height=h, width=w, seed=0, back_context=0,
                                 forward_context=0, depth_density=SAN_GT_DENSITY)[0]
    depth = sample["depth"][None]
    keep = np.random.default_rng(0).uniform(size=depth.shape) < SAN_INPUT_DENSITY / SAN_GT_DENSITY
    return {"rgb": sample["rgb"][None], "depth": depth,
            "input_depth": (depth * keep).astype(np.float32)}


def san_cpu_reference(model, device):
    """PackNet-SAN's model_loss at SAN_CPU_HW, batch 1, on the card and on
    the CPU with the same weights, in the bfloat16 policy: each loss term
    and the full-resolution inverse depths of both passes, held at the
    float32 tolerance (SAN takes no compute dtype, so both sides compute in
    float32 on the same bfloat16-rounded inputs). The inverse depths' spread
    is printed, so that an output that does not depend on the computation
    would show."""
    import torch

    from packnet_sfm_tpu_torch.core.config import SAN_KITTI, config_from_dict
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.models.sfm import model_loss

    batch = san_batch(*SAN_CPU_HW)
    cfg = config_from_dict(SAN_KITTI)
    cpu_model = setup_model(cfg.model, device="cpu", dtype=torch.bfloat16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    terms, inv = {}, {}
    for name, m, dev in (("card", model, device), ("cpu", cpu_model, "cpu")):
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            _, (metrics, out) = model_loss(m, prepared(batch, dev, torch.bfloat16),
                                           generator=gen)
        if out["inv_depths"][0].device.type != torch.device(dev).type:
            raise AssertionError(f"SAN's {name} run computed on {out['inv_depths'][0].device}")
        terms[name] = {k: metrics[k].item() for k in ("supervised_loss", "supervised_loss_rgbd",
                                                      "depth_loss", "loss")}
        inv[name] = {k: out[k][0].float().cpu() for k in ("inv_depths", "inv_depths_rgbd")}
    rel = max(abs(terms["card"][k] - terms["cpu"][k]) / abs(terms["cpu"][k]) for k in terms["cpu"])
    log(f"SAN model_loss {SAN_CPU_HW[0]}x{SAN_CPU_HW[1]} batch 1, bfloat16 policy (float32 "
        "compute): " + "; ".join(f"{k} card {terms['card'][k]:.9g} cpu {terms['cpu'][k]:.9g}"
                                  for k in terms["cpu"])
        + f"; largest rel {rel:.2e} (tolerance {TOL_LOSS_CPU:g})")
    inv_err = 0.0
    for k, ref in inv["cpu"].items():
        err = (inv["card"][k] - ref).abs().max().item() / ref.abs().max().item()
        inv_err = max(inv_err, err)
        log(f"SAN {k}[0] cpu min {ref.min().item():.6g} max {ref.max().item():.6g} std "
            f"{ref.std().item():.6g}; card std {inv['card'][k].std().item():.6g}; max |card - "
            f"cpu| / max {err:.2e} (tolerance {TOL_LOSS_CPU:g})")
    if not (rel <= TOL_LOSS_CPU and inv_err <= TOL_LOSS_CPU):
        raise AssertionError("SAN's model_loss on the card disagrees with the CPU")
    return {"terms": terms, "max_rel": rel, "inv_depths_max_rel": inv_err}


def san_kitti_run(device, root, out):
    """(a): train_packnet_san_kitti.yaml on the KITTI tree through the fit,
    the first step's loss against the CPU, then the eval protocol with and
    without input depth, float32 and --half, then infer."""
    import shutil

    import numpy as np

    from packnet_sfm_tpu_torch.cli.eval import evaluate
    from packnet_sfm_tpu_torch.cli.infer import infer_and_save
    from packnet_sfm_tpu_torch.core.config import config_from_dict
    from packnet_sfm_tpu_torch.engine.factory import compute_dtype, setup_model
    from packnet_sfm_tpu_torch.engine.train import EVAL_MODES

    ckpt_dir = out / "san_ckpt"
    cfg = san_kitti_config(root, {"filepath": str(ckpt_dir), "save_top_k": 1})
    parsed = config_from_dict(cfg)
    rel = san_cpu_reference(setup_model(parsed.model, device=device, seed=parsed.arch.seed,
                                        dtype=compute_dtype(parsed)), device)
    rec = data_train_run(device, cfg, NO_LAUNCHES, "KITTI train_packnet_san_kitti.yaml")
    terms = {k: rec["metrics"][k] for k in ("supervised_loss", "supervised_loss_rgbd",
                                             "depth_loss", "loss")}
    log(f"SAN KITTI: step {rec['bare_step_ms']:.2f} ms (median of the bare steps 2-N, 352x1216, "
        f"batch 1, two passes), peak {rec['peak_mib']:.1f} MiB; the epoch's terms {terms}")
    if not all(np.isfinite(v) for v in terms.values()):
        raise AssertionError(f"SAN's loss terms: {terms}")
    (ckpt,) = sorted(ckpt_dir.iterdir())

    reset_counts()
    tables, secs = {}, {}
    for rows, half in (("rgbd", False), ("rgb", False), ("rgbd", True), ("rgb", True)):
        ecfg = san_kitti_config(root)
        if rows == "rgb":
            ecfg["datasets"]["test"]["input_depth_type"] = [""]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tables[rows, half] = evaluate(str(ckpt), ecfg, half=half, device=device)[0]
        secs[rows, half] = time.perf_counter() - t0
    for key, table in tables.items():
        log(f"SAN eval {key[0]} rows{' --half' if key[1] else ''} ({secs[key]:.1f} s): "
            + ", ".join(f"{m} abs_rel {table[m][0]:.4f}" for m in EVAL_MODES))
    lidar = max(float(np.abs(tables["rgbd", False][m] - tables["rgb", False][m]).max())
                for m in EVAL_MODES)
    half = max(float(np.abs(tables[r, True][m] - tables[r, False][m]).max())
               for r in ("rgb", "rgbd") for m in EVAL_MODES)
    log(f"SAN eval: max |rgbd - rgb| {lidar:.3e} (the lidar reaches the graph); max |--half - "
        f"float32| {half:.3e} (tolerance {TOL_PROTOCOL:g}: SAN takes no compute dtype, so "
        "--half computes in float32)")
    if not (lidar > 0 and half <= TOL_PROTOCOL) or not all(
            np.all(np.isfinite(t[m])) for t in tables.values() for m in EVAL_MODES):
        raise AssertionError(f"SAN eval tables: {tables}")

    frames = root / KITTI_DRIVES[0][0] / f"{KITTI_DRIVES[0][0]}_drive_{KITTI_DRIVES[0][1]:04d}_sync" \
        / "image_02" / "data"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        infer_and_save(str(ckpt), str(frames), str(out / "san_infer"), image_shape=(352, 1216),
                       save="npz", device=device)
    infer_s = time.perf_counter() - t0
    depths = [np.load(p)["depth"] for p in sorted((out / "san_infer").glob("*.npz"))]
    counts = read_counts()
    log(f"SAN infer (rgb only) on {len(depths)} frames at 352x1216: {infer_s:.1f} s; launches "
        f"during eval and infer {counts}")
    if len(depths) != KITTI_FRAMES or any(d.shape != (352, 1216) or not np.all(np.isfinite(d))
                                          for d in depths) or any(counts.values()):
        raise AssertionError("SAN infer outputs or launches")
    shutil.rmtree(ckpt_dir, ignore_errors=True)         # 1.3 GB of weights and Adam moments
    rec.update(cpu_reference=rel, terms=terms, eval_seconds={f"{r}{'_half' if h else ''}": v
                                                            for (r, h), v in secs.items()},
               eval_abs_rel={f"{r}{'_half' if h else ''}": {m: float(t[m][0]) for m in EVAL_MODES}
                             for (r, h), t in tables.items()},
               eval_rgbd_vs_rgb_max_abs_diff=lidar, eval_half_vs_float32_max_abs_diff=half,
               infer_frames=len(depths), infer_seconds=infer_s)
    return rec


def models_phase(device):
    """Phase 9 (see the module docstring); returns its numbers."""
    import copy

    from packnet_sfm_tpu_torch.core.config import OVERFIT_KITTI, OVERFIT_SUPERVISED, SAN_DDAD

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_data"
    kitti, dgp = root / "KITTI_raw", root / "DDAD"
    result = {"san_kitti": san_kitti_run(device, kitti, root)}

    cfg = copy.deepcopy(SAN_DDAD)
    cfg["arch"]["max_epochs"] = 1
    for split in ("train", "validation", "test"):
        cfg["datasets"][split]["path"] = [str(dgp)]
    result["san_ddad"] = data_train_run(device, cfg, NO_LAUNCHES,
                                        "DGP train_packnet_san_ddad.yaml")

    cfg = copy.deepcopy(OVERFIT_SUPERVISED)
    rec = data_train_run(device, cfg, NO_LAUNCHES, "overfit_packnet_supervised.yaml",
                         bare=False)
    abs_rel = rec["depth_gt_abs_rel_by_epoch"]
    log(f"overfit_packnet_supervised.yaml: depth_gt abs_rel by epoch {abs_rel} (bar: epoch 1 "
        f"< {SUPERVISED_BAR} and below epoch 0)")
    if not (abs_rel[1] < SUPERVISED_BAR and abs_rel[1] < abs_rel[0]):
        raise AssertionError(f"the supervised recipe missed the bar: {abs_rel}")
    result["supervised"] = rec

    for version in ("18", "50"):
        cfg = copy.deepcopy(OVERFIT_KITTI)
        cfg["arch"]["max_epochs"] = 1
        cfg["model"]["depth_net"]["version"] = cfg["model"]["pose_net"]["version"] = version
        cfg["datasets"]["train"].update(path=[str(kitti)], split=["train.txt"], repeat=[1])
        for split in ("validation", "test"):
            cfg["datasets"][split].update(path=[str(kitti)], split=["val.txt"])
        result[f"overfit_kitti_{version}"] = data_train_run(
            device, cfg, OVERFIT_KITTI_LAUNCHES,
            f"overfit_kitti.yaml, DepthResNet-{version} + PoseResNet-{version}")

    cfg = kitti_train_config(kitti)
    cfg["model"]["name"] = "VelSupModel"
    result["velsup"] = data_train_run(device, cfg, FLAGSHIP_LAUNCHES,
                                      "VelSupModel on train_kitti.yaml's networks")
    if not result["velsup"]["metrics"].get("velocity_loss", 0) > 0:
        raise AssertionError(f"VelSup's velocity term: {result['velsup']['metrics']}")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 9 took {result['seconds']:.1f} s")
    return result


# Phase 10: ego-motion, export and conversion, on phase 7's KITTI tree (the
# first drive's 20 frames, 375x1242, resized to the checkpoint's 192x640)
# and phase 7's train_kitti.yaml checkpoint (PackNet01-1A + PoseNet at full
# width; cli.odometry builds it in float32 whatever arch.dtype says, as the
# JAX CLI does, so the frames and the warp are float32). cli.odometry runs
# three times: plain, --refine-direct, and --refine-direct --refine-ba.
ODOMETRY_RUNS = (("plain", {}), ("direct", {"refine_direct": True}),
                 ("direct_ba", {"refine_direct": True, "refine_ba": True}))
# refine_relative_poses' Gauss-Newton steps a pair, the forward-mode columns
# of a step's Jacobian (one warp_jvp each), and the warps of a step besides:
# the residual at 0, the six columns' own forward and the three trials of
# the line search; one more a pair for the final residual
DIRECT_ITERATIONS, JVP_COLUMNS, FWD_PER_ITERATION = 8, 6, 10
# The card against the same CLI on the CPU, on the drive's first CPU_FRAMES
# frames (the CPU's three runs took 91 s on the first 8 frames: over the
# whole drive they would take minutes; 5 frames took 67 s, so that phase
# 11 fits, 3 frames a run): the largest difference of a pose
# matrix entry (rotations, and translations in the predicted scale).
# Float32 networks whose convolutions sum in other orders on the two
# devices, then 8 Gauss-Newton steps a pair whose line search may take
# another trial where two costs tie; measured on an H100 over 8 frames:
# plain 6.0e-8, --refine-direct 2.0e-5, both refinements 5.7e-6.
CPU_FRAMES = 3
TOL_ODOMETRY_CPU = 1e-3
# warp_jvp on the first pair's real depth and pose against the plain warp
# under forward AD, relative to the tangent's largest magnitude
TOL_WARP_JVP = TOL_WARP_GRAD
# The native solver (float64, central differences) against optimize_pose_graph
# on the card (float32, forward mode) on the run's first window: poses, as
# tests/test_native.py holds them. Two gloo ranks on the card against one
# process: the same float32 sums split in two halves (12 iterations).
TOL_NATIVE_POSES = 5e-3
TOL_POSEGRAPH_RANKS = 1e-4
# The exported depth forward, run in a process that imports only torch (TF32
# off, as here), against infer's forward of the same model: TOL_INFER and
# TOL_INFER_HALF, relative to the largest inverse depth.
EXPORT_LOADER = """
import json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rgb = torch.load(sys.argv[1]).cuda()
for program, result in zip(sys.argv[2::2], sys.argv[3::2]):
    fn = torch.export.load(program).module()
    with torch.no_grad():
        torch.save(fn(rgb).cpu(), result)
print(json.dumps(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                        or m.startswith("packnet_sfm_tpu"))))
"""


def oxts_poses(drive, n):
    """The drive's OXTS poses of its first ``n`` frames, relative to the
    first, in the IMU frame (datasets/kitti_utils.pose_from_oxts_packet)."""
    import numpy as np

    from packnet_sfm_tpu_torch.datasets.kitti_utils import (
        pose_from_oxts_packet, transform_from_rot_trans)

    packets = [np.loadtxt(drive / "oxts" / "data" / f"{i:010d}.txt") for i in range(n)]
    scale = np.cos(packets[0][0] * np.pi / 180.0)
    origin = transform_from_rot_trans(*pose_from_oxts_packet(packets[0], scale))
    return np.stack([np.linalg.inv(origin) @ transform_from_rot_trans(
        *pose_from_oxts_packet(p, scale)) for p in packets])


def odometry_run(ckpt, frames, gt, out, device, **flags):
    """``cli.odometry.run_odometry`` with the launch counters read around
    it; returns (trajectory, record). ``flags`` go to run_odometry
    (refine_direct, refine_ba, max_frames)."""
    import torch

    from packnet_sfm_tpu_torch.cli.odometry import run_odometry

    printed = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        traj = run_odometry(str(ckpt), str(frames), output=str(out), gt=str(gt),
                            device=device, **flags)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    metrics = json.loads(printed.getvalue().strip().splitlines()[-1])
    return traj, dict(seconds=secs, seconds_per_frame=secs / metrics["frames"],
                      launches=counts, **metrics)


def warp_jvp_on_real_depth(model, frames, K, T0, device):
    """warp_jvp against the plain warp under forward AD on the first pair's
    real coordinates (its predicted depth, the pose net's pose) and their
    tangents along the six twist coordinates; returns the worst relative
    difference."""
    import torch

    from packnet_sfm_tpu_torch.geometry.camera import Camera, project, reconstruct
    from packnet_sfm_tpu_torch.geometry.se3 import se3_exp
    from packnet_sfm_tpu_torch.losses.photometric import inv2depth
    from packnet_sfm_tpu_torch.models.sfm import model_forward
    from packnet_sfm_tpu_torch.ops import warp

    target = torch.from_numpy(frames[0:1]).to(device)
    ref = torch.from_numpy(frames[1:2]).to(device)
    Kt = torch.from_numpy(K[None]).to(device)
    T0 = torch.from_numpy(T0).to(device)
    with torch.no_grad():
        depth = inv2depth(model_forward(model, {"rgb": target}, train=False)["inv_depths"][0])

    def coords_of(xi):
        T = se3_exp(xi[None])[0] @ T0
        return project(Camera(K=Kt, Tcw=T[None]), reconstruct(Camera(K=Kt), depth))

    xi0, eye = torch.zeros(6, device=device), torch.eye(6, device=device)
    worst = 0.0
    for i in range(JVP_COLUMNS):
        coords, tangent = torch.func.jvp(coords_of, (xi0,), (eye[i],))
        got = warp.warp_jvp_cuda(ref, coords.contiguous(), tangent.contiguous())
        want = torch.func.jvp(lambda c: warp.grid_sample_plain(ref, c), (coords,), (tangent,))[1]
        worst = max(worst, (got - want).abs().max().item() / want.abs().max().item())
    return worst


def odometry_phase(device):
    """Phase 10 (see the module docstring); returns its numbers."""
    import shutil

    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.cli.convert_checkpoint import convert
    from packnet_sfm_tpu_torch.cli.export import export_checkpoint
    from packnet_sfm_tpu_torch.cli.infer import make_depth_fn
    from packnet_sfm_tpu_torch.cli.odometry import kitti_intrinsics, load_frames
    from packnet_sfm_tpu_torch.core.config import ConfigNode
    from packnet_sfm_tpu_torch.egomotion.evaluation import save_kitti_odometry_poses
    from packnet_sfm_tpu_torch.egomotion.odometry import (
        predict_skip_poses, trajectory_from_relative, window_edges)
    from packnet_sfm_tpu_torch.egomotion.posegraph import PoseGraphConfig, optimize_pose_graph
    from packnet_sfm_tpu_torch.engine.checkpoint import restore_checkpoint
    from packnet_sfm_tpu_torch.engine.factory import setup_model
    from packnet_sfm_tpu_torch.native import solve_pose_graph_native
    from packnet_sfm_tpu_torch.utils.torch_import import reference_state_dict

    t_phase = time.perf_counter()
    data = ROOT / "build" / "chip_smoke_data"
    (ckpt,) = sorted((data / "kitti_ckpt").iterdir())
    date, num, _ = KITTI_DRIVES[0]
    drive = data / "KITTI_raw" / date / f"{date}_drive_{num:04d}_sync"
    frames_dir = drive / "image_02" / "data"
    out = data / "odometry"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    gt = out / "gt.txt"
    save_kitti_odometry_poses(str(gt), oxts_poses(drive, KITTI_FRAMES))
    result, failures = {"checkpoint": ckpt.name, "frames": KITTI_FRAMES}, []

    def expected(launches, frames, direct):
        want = {k: 0 for k in launches}
        if direct:
            want["warp_jvp"] = (frames - 1) * DIRECT_ITERATIONS * JVP_COLUMNS
            want["warp_fwd"] = (frames - 1) * (DIRECT_ITERATIONS * FWD_PER_ITERATION + 1)
        return want

    # 1. the CLI three times on the card over the drive, then on its first
    # CPU_FRAMES frames on the card and on the CPU
    trajs = {}
    for name, flags in ODOMETRY_RUNS:
        trajs[name], rec = odometry_run(ckpt, frames_dir, gt, out / f"{name}.txt", device,
                                        **flags)
        want = expected(rec["launches"], KITTI_FRAMES, flags.get("refine_direct", False))
        log(f"odometry {name} on the card: {rec['seconds']:.1f} s, {rec['seconds_per_frame']:.3f} "
            f"s a frame (model build and restore included); ATE {rec['ate_rmse_m']} m, RPE "
            f"{rec['rpe_trans_m']} m / {rec['rpe_rot_deg']} deg; launches {rec['launches']}")
        if rec["launches"] != want:
            failures.append(f"odometry {name}: launches {rec['launches']}, expected {want}")
        if not np.isfinite(trajs[name]).all():
            failures.append(f"odometry {name}: non-finite trajectory")
        result[name] = rec
    for name, flags in ODOMETRY_RUNS:
        card, card_rec = odometry_run(ckpt, frames_dir, gt, out / f"{name}_short.txt", device,
                                      max_frames=CPU_FRAMES, **flags)
        cpu, cpu_rec = odometry_run(ckpt, frames_dir, gt, out / f"{name}_cpu.txt", "cpu",
                                    max_frames=CPU_FRAMES, **flags)
        diff = float(np.abs(card - cpu).max())
        want = expected(card_rec["launches"], CPU_FRAMES, flags.get("refine_direct", False))
        result[name].update(cpu_frames=CPU_FRAMES, cpu_seconds=cpu_rec["seconds"],
                            short_card_seconds=card_rec["seconds"],
                            card_vs_cpu_max_abs_diff=diff)
        log(f"odometry {name} on {CPU_FRAMES} frames: card {card_rec['seconds']:.1f} s, CPU "
            f"{cpu_rec['seconds']:.1f} s; ATE {card_rec['ate_rmse_m']} / {cpu_rec['ate_rmse_m']} "
            f"m; max |card - CPU| over the trajectory {diff:.3e} (tolerance "
            f"{TOL_ODOMETRY_CPU:g})")
        if not diff <= TOL_ODOMETRY_CPU:
            failures.append(f"odometry {name}: card against CPU {diff:.3e}")
        if card_rec["launches"] != want or any(cpu_rec["launches"].values()):
            failures.append(f"odometry {name} on {CPU_FRAMES} frames: launches "
                            f"{card_rec['launches']} / {cpu_rec['launches']}")

    # 2. warp_jvp on the first pair's real depth and pose
    config = ConfigNode.from_dict(json.loads((ckpt / "meta.json").read_text())["config"])
    model = setup_model(config.model, device=device)
    restore_checkpoint(str(ckpt), model)
    frames = load_frames(str(frames_dir), tuple(config.datasets.augmentation.image_shape))
    K = kitti_intrinsics(*frames.shape[1:3])
    rel = np.stack([np.linalg.inv(a) @ b for a, b in zip(trajs["plain"][:-1],
                                                           trajs["plain"][1:])]).astype(np.float32)
    result["warp_jvp_real_rel_err"] = warp_jvp_on_real_depth(model, frames, K, rel[0], device)
    log(f"warp_jvp on the first pair's real depth and pose, six twist directions: "
        f"{result['warp_jvp_real_rel_err']:.3e} of the largest (tolerance {TOL_WARP_JVP:g})")
    if not result["warp_jvp_real_rel_err"] <= TOL_WARP_JVP:
        failures.append("warp_jvp on real data disagrees with its plain version")

    # 3. the native solver and two ranks against optimize_pose_graph on the
    # card, on the CLI's first window with the skip measurements as extra edges
    extra = predict_skip_poses(model, frames, 2) + predict_skip_poses(model, frames, 3)
    traj0 = trajectory_from_relative(rel)
    cfg = PoseGraphConfig(optimize_scales=False)
    edges = window_edges(rel, 0, 10, extra)
    T_t, _, _ = optimize_pose_graph(torch.from_numpy(traj0[:10]).to(device),
                                    {k: torch.from_numpy(v).to(device) for k, v in edges.items()},
                                    cfg)
    t0 = time.perf_counter()
    T_n, _, _ = solve_pose_graph_native(traj0[:10], edges, num_iterations=cfg.num_iterations,
                                        optimize_scales=False)
    native_s = time.perf_counter() - t0
    native_diff = float(np.abs(T_n - T_t.cpu().numpy()).max())
    log(f"native solver on the first window ({len(edges['i'])} edges, 10 poses) in "
        f"{native_s * 1e3:.1f} ms: max |native - optimize_pose_graph| {native_diff:.3e} "
        f"(tolerance {TOL_NATIVE_POSES:g})")
    if not native_diff <= TOL_NATIVE_POSES:
        failures.append(f"native solver {native_diff:.3e}")
    edges9 = window_edges(rel, 0, 9, extra)            # 21 edges: padded to 22 on two ranks
    graph = ROOT / "build" / "chip_smoke_dist" / "posegraph.npz"
    graph.parent.mkdir(parents=True, exist_ok=True)
    np.savez(graph, T_init=traj0[:9], **edges9)
    one = optimize_pose_graph(torch.from_numpy(traj0[:9]).to(device),
                              {k: torch.from_numpy(v).to(device) for k, v in edges9.items()},
                              PoseGraphConfig())
    # the two ranks run while the export and the conversion below do
    posegraph_ranks = dist_job(2, "posegraph_2rank", wait=False, kind="posegraph",
                               backend="gloo", device="cuda:0", graph=str(graph))
    result.update(native_vs_torch_max_abs_diff=native_diff, native_ms=native_s * 1e3)

    # 4. cli.export, float32 and --half, both run in one process that imports
    # only torch
    rgb = torch.from_numpy(frames[:1])
    torch.save(rgb, out / "rgb.pt")
    exports = {"float32": (False, TOL_INFER), "half": (True, TOL_INFER_HALF)}
    result["export"], args = {}, []
    for name, (half, _) in exports.items():
        path = out / f"depth_{name}.pt2"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            size = export_checkpoint(str(ckpt), str(path), half=half, device=device)
        result["export"][name] = dict(mb=size / 1e6, seconds=time.perf_counter() - t0)
        args += [str(path), str(out / f"exported_{name}.pt")]
    # the torch-only process runs while the conversion below does
    t0 = time.perf_counter()
    loader = subprocess.Popen([sys.executable, "-c", EXPORT_LOADER, str(out / "rgb.pt"), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(out))

    # 5. cli.convert_checkpoint on a reference-format .ckpt of the same weights
    src = out / "reference.ckpt"
    torch.save({"config": {"model": {"name": "SelfSupModel",
                                     "depth_net": {"name": "PackNet01", "version": "1A"},
                                     "pose_net": {"name": "PoseNet"}}},
                "epoch": 0, "state_dict": reference_state_dict(model)}, src)
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        converted = convert(str(src), str(out / "converted"))
    convert_s = time.perf_counter() - t1
    meta = json.loads((pathlib.Path(converted) / "meta.json").read_text())
    back = setup_model(ConfigNode.from_dict(meta["config"]).model, device=device, seed=1)
    restore_checkpoint(converted, back)
    equal = bool(torch.equal(make_depth_fn(back)(rgb.to(device)), make_depth_fn(model)(rgb.to(device))))
    log(f"convert_checkpoint of a reference-format .ckpt ({src.stat().st_size / 1e6:.1f} MB) in "
        f"{convert_s:.1f} s: the converted model's inverse depth equal to the original's: {equal}")
    if not equal:
        failures.append("the converted checkpoint's inverse depth differs")
    result.update(convert_seconds=convert_s, convert_equal=equal)
    shutil.rmtree(out / "converted")
    src.unlink()

    try:
        stdout, stderr = loader.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        loader.kill()
        raise AssertionError("the exported models' loader did not finish in 600 s")
    if loader.returncode != 0:
        raise AssertionError(f"the exported models do not run:\n{stderr[-3000:]}")
    leaked = json.loads(stdout.strip().splitlines()[-1])
    log(f"export: both programs loaded and run in a torch-only process in "
        f"{time.perf_counter() - t0:.1f} s (the conversion beside it); modules of jax or the "
        f"port there: {leaked}")
    if leaked:
        failures.append(f"the export's loader imported {leaked}")
    for name, (half, tol) in exports.items():
        got = torch.load(out / f"exported_{name}.pt")
        ref_model = setup_model(config.model, device=device,
                                dtype=torch.bfloat16 if half else None)
        restore_checkpoint(str(ckpt), ref_model)
        want = make_depth_fn(ref_model)(rgb.to(device)).cpu()
        err = (got - want).abs().max().item() / want.abs().max().item()
        rec = result["export"][name]
        rec["rel_err"] = err
        log(f"export {name}: {rec['mb']:.1f} MB in {rec['seconds']:.1f} s; "
            f"{tuple(got.shape)} {got.dtype} against infer's forward {err:.3e} of the largest "
            f"(tolerance {tol:g})")
        if got.dtype != torch.float32 or tuple(got.shape) != tuple(want.shape) or not err <= tol:
            failures.append(f"export {name}: {err:.3e}")
        (out / f"depth_{name}.pt2").unlink()
        del ref_model

    ranks = posegraph_ranks()
    ranks_diff = max(float(np.abs(np.asarray(r["T"]) - one[0].cpu().numpy()).max())
                     for r in ranks)
    log(f"optimize_pose_graph_sharded on two gloo ranks of card 0 ({len(edges9['i'])} edges) "
        f"against one process: max |T| difference {ranks_diff:.3e} (tolerance "
        f"{TOL_POSEGRAPH_RANKS:g}); cost {ranks[0]['cost']:.6g} against {float(one[2]):.6g}")
    if not (ranks_diff <= TOL_POSEGRAPH_RANKS and ranks[0]["T"] == ranks[1]["T"]):
        failures.append(f"two-rank pose graph {ranks_diff:.3e}")
    result.update(two_ranks_vs_one_max_abs_diff=ranks_diff)

    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 took {result['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))
    return result


# Phase 11: the (data x space) grid at the JAX package's HR recipe
# (tools/hr_2dmesh.py: PackNet01-1A + PoseNet, float32, remat on, 384x1280,
# batch 1, weights and frames from seed 0): one process as the recipe runs
# it (the fused pack conv at this size), one process with the two-step pack
# conv that a space axis takes, and two space ranks over gloo on card 0
# (NCCL refuses two ranks on one card), all from the same weights and batch.
# The grid against the two-step process: the first step's loss relative and
# the cosine of the first Adam update, as tests/test_torch_spatial.py holds
# them. Against the fused process the loss alone: Adam's first update is
# about lr * sign(g), and the fused and two-step convolutions round
# differently, which flips the sign of near-zero gradients (the two
# processes' update cosine is the figure beside it). 4 launches of warp_fwd
# and warp_bwd a step on each rank; each rank's peak below the fused
# process's.
SPACE_STEPS = 2
SPACE_TIMEOUT = 240
TOL_SPACE_LOSS = 1e-5
TOL_SPACE_COS = 0.9999
SPACE_RUNS = (("one_process", 1, "auto"), ("one_process_two_step", 1, "two_step"),
              ("space_2", 2, "auto"))


def hr_worker(root, label, runs, nproc):
    """The ``hr_runs`` job of ``runs`` ([label, tools/hr_2dmesh.py's
    arguments, dtype, perturb seed or None] each) on card 0: in one process
    (``chip_smoke.py --worker``), or on ``nproc`` gloo ranks in one process
    group; waits for it."""
    import os

    job = root / f"{label}.json"
    job.write_text(json.dumps(dict(kind="hr_runs", out=str(root), label=label, runs=runs,
                                   backend="gloo", device="cuda:0")))
    worker = [ROOT / "chip_smoke.py", "--worker", job]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    finish(torchrun(nproc, worker) if nproc > 1 else subprocess.Popen(
        [sys.executable] + [str(a) for a in worker], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True), f"space_{label}",
        timeout=SPACE_TIMEOUT)
    log(f"{label}: {time.perf_counter() - t0:.1f} s with the start")


def hr_runs(root):
    """tools/hr_2dmesh.py on card 0: SPACE_RUNS's one-process runs in one
    process, then the grid's ranks through the tool's own launch; returns
    each run's JSON line."""
    args = ["--data", "1", "--steps", str(SPACE_STEPS), "--device", "cuda:0"]
    hr_worker(root, "hr_one_process",
              [[label, args + ["--space", "1", "--pack-mode", mode], "float32", None]
               for label, space, mode in SPACE_RUNS if space == 1], 1)
    for label, space, mode in SPACE_RUNS:
        if space > 1:
            t0 = time.perf_counter()
            finish(torchrun(space, ["-m", "packnet_sfm_tpu_torch.tools.hr_2dmesh", "--worker"]
                            + args + ["--space", str(space), "--pack-mode", mode,
                                      "--backend", "gloo", "--out", root / f"{label}.json"]),
                   f"space_{label}", timeout=SPACE_TIMEOUT)
            log(f"{label}: {time.perf_counter() - t0:.1f} s with the start")
    runs = {label: json.loads((root / f"{label}.json").read_text()) for label, _, _ in SPACE_RUNS}
    for label, r in runs.items():
        log(f"{label} (pack mode {r['pack_mode']}): losses {r['losses']}, step "
            f"{r['step_ms']:.2f} ms (steps 2-{SPACE_STEPS} of {SPACE_STEPS}), peak MiB by rank "
            f"{[round(x['peak_mib'], 1) for x in r['ranks']]}, launches by rank "
            f"{[x['launches'] for x in r['ranks']]}, collectives a step "
            f"{r['ranks'][0]['collectives_per_step']}")
    return runs


def space_phase():
    """Phase 11 (see the module docstring); returns its numbers."""
    import torch

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_space"
    root.mkdir(parents=True, exist_ok=True)
    (ROOT / "build" / "chip_smoke_dist").mkdir(parents=True, exist_ok=True)
    log(gpu_name_and_power())
    runs = hr_runs(root)
    first = {k: torch.load(root / f"{k}.json.update.pt") for k in runs}
    for k in runs:
        (root / f"{k}.json.update.pt").unlink()

    def cos(a, b, key):
        u, v = first[a][key].double(), first[b][key].double()
        return float(u @ v / u.norm() / v.norm())

    def loss_rel(a, b):
        return [abs(x - y) / abs(x) for x, y in zip(runs[a]["losses"], runs[b]["losses"])]

    pairs = (("one_process_two_step", "space_2"), ("one_process", "space_2"),
             ("one_process", "one_process_two_step"))
    agree = {f"{a}/{b}": dict(loss_rel=loss_rel(a, b), update_cos=cos(a, b, "update"),
                              grad_cos=cos(a, b, "grad")) for a, b in pairs}
    for pair, r in agree.items():
        log(f"{pair}: loss relative by step {r['loss_rel']}, first update's cosine "
            f"{r['update_cos']:.7f}, first gradient's {r['grad_cos']:.9f}")
    one, two_step, grid = runs["one_process"], runs["one_process_two_step"], runs["space_2"]
    peak_share = [x["peak_mib"] / one["ranks"][0]["peak_mib"] for x in grid["ranks"]]
    log(f"each rank's peak {peak_share} of the one process's, "
        f"{[x['peak_mib'] / two_step['ranks'][0]['peak_mib'] for x in grid['ranks']]} of the "
        f"two-step process's; step {grid['step_ms'] / one['step_ms']:.2f}x the one process's, "
        f"{grid['step_ms'] / two_step['step_ms']:.2f}x the two-step process's")
    want = {"warp_fwd": 4 * SPACE_STEPS, "warp_bwd": 4 * SPACE_STEPS}
    if not all(x["launches"] == {k: want.get(k, 0) for k in x["launches"]}
               for r in runs.values() for x in r["ranks"]):
        raise AssertionError(f"launches other than 4 of each float32 warp a step: {runs}")
    like = agree["one_process_two_step/space_2"]
    if not (like["loss_rel"][0] <= TOL_SPACE_LOSS and like["update_cos"] >= TOL_SPACE_COS
            and agree["one_process/space_2"]["loss_rel"][0] <= TOL_SPACE_LOSS
            and all(s < 1.0 for s in peak_share)
            and all(all(map(math.isfinite, r["losses"])) for r in runs.values())):
        raise AssertionError("the space grid's step parts from one process's")
    seconds = time.perf_counter() - t_phase
    log(f"phase 11 took {seconds:.1f} s")
    return dict(runs=runs, agreement=agree, peak_share=peak_share, seconds=seconds)


# Phase 12: the rest of the grid's kinds. (a) The band forms of K6f/K6b at
# the omnicam projection grid (half of 384x384), on the two bands of rows of
# 96 that phase 12's omnicam grid runs, each with the ray slab its windows
# read. Against the plain band version: TOL_PX and TOL_GRAD. Against the
# whole-image kernel: ex, ey and d direction of the band's rows, and the
# bands' d rays summed into the image's rows (as the halo's backward sums
# them), within TOL_BAND_WHOLE of the largest value: the band form computes
# each window with the whole kernel's roundings, and only the d rays' sums
# over a tile run in another order. A band's bound is half the whole
# kernel's: 96 x 192 x 41^2 = 31 M window positions.
BAND_ROWS = 96
TOL_BAND_WHOLE = 1e-6
# (b)-(d): tools/hr_2dmesh.py's recipes for SPACE_KIND_STEPS steps, in one
# process (hr_velsup and semisup with the two-step pack conv that a band
# takes) and on two space ranks over gloo on card 0, all from the same
# weights and batch; the grid against the one process by phase 11's bounds
# (the first loss and each loss term relative, the first update's cosine).
# omnicam's objective is chaotic at T ~ 1e-4: its first loss relative by
# TOL_SPACE_LOSS and its first gradient's cosine by TOL_OMNICAM_GRAD_COS,
# under the port's own floor (one process from weights moved by a relative
# 1e-7, FLOOR_DRAWS draws, measured in every run: on an H100 at 700 W a
# first gradient's cosine of 0.9933-0.9961 over 3 draws, and the grid's
# 0.99474, its first loss 2.5e-6 apart), as tests/test_torch_train_step.py
# sets its bounds. Then omnicam in bfloat16
# (the config as written) on the grid: finite losses and its launches.
SPACE_KIND_STEPS = 2
FLOOR_DRAWS = 3
TOL_OMNICAM_GRAD_COS = 0.99
KIND_ONE_PROCESS = (("hr_velsup", "two_step"), ("omnicam", "auto"), ("semisup", "two_step"))
KIND_GRID = (("hr_velsup", "float32"), ("omnicam", "float32"), ("omnicam", "bfloat16"),
             ("semisup", "float32"))
# launches a step on each rank (one process: the whole-image soft-argmax)
KIND_LAUNCHES = {
    "hr_velsup": {"warp_fwd": 4, "warp_bwd": 4},
    "semisup": {"warp_fwd": 4, "warp_bwd": 4},
    "omnicam": {"softargmax_fwd": 2, "softargmax_bwd": 2, "warp_fwd": 2, "warp_bwd": 2},
    "omnicam_grid": {"softargmax_fwd_band": 2, "softargmax_bwd_band": 2, "warp_fwd": 2,
                     "warp_bwd": 2},
    "omnicam_grid_bf16": {"softargmax_fwd_band": 2, "softargmax_bwd_band": 2,
                          "warp_fwd_bf16": 2, "warp_bwd_bf16": 2},
}


def band_kernel_phase(device, path_temperature):
    """Phase 12 (a); returns the band forms' numbers for the kernels line."""
    import torch

    from packnet_sfm_tpu_torch.ops import softargmax as sa

    h = w = 192
    gen = torch.Generator().manual_seed(4)
    d, r = unit(gen, (1, 3, h, w), device), unit(gen, (1, 3, h, w), device)
    a, c = (torch.randn((1, h, w), generator=gen).to(device) for _ in range(2))
    err = {"fwd": 0.0, "bwd": 0.0}
    whole_err = 0.0
    cases = []
    for t in (path_temperature, DENSE_T):
        ex, ey, m, s = sa.softargmax_fwd_cuda(d, r, t, PATCH)
        ddir, drays = sa.softargmax_bwd_cuda(d, r, t, PATCH, ex, ey, m, s, a, c)
        summed = torch.zeros_like(drays)
        tol = 1e-4 if t < 1e-2 else DENSE_T
        for row0 in range(0, h, BAND_ROWS):
            rows = slice(row0, row0 + BAND_ROWS)
            first, stop = sa.ray_slab(row0, BAND_ROWS, h, PATCH)
            db, slab = d[:, :, rows].contiguous(), r[:, :, first:stop].contiguous()
            ab, cb = a[:, rows].contiguous(), c[:, rows].contiguous()
            band = (row0, h, first)
            bex, bey, bm, bs = sa.softargmax_fwd_band_cuda(db, slab, t, PATCH, *band)
            bdir, brays = sa.softargmax_bwd_band_cuda(db, slab, t, PATCH, *band, bex, bey, bm,
                                                      bs, ab, cb)
            again = sa.softargmax_bwd_band_cuda(db, slab, t, PATCH, *band, bex, bey, bm, bs,
                                                ab, cb)
            if not (torch.equal(bdir, again[0]) and torch.equal(brays, again[1])):
                raise AssertionError("K6b's band form returned other bits on a second call")
            summed[:, :, first:stop] += brays
            # against the plain band version
            dp, rp = db.clone().requires_grad_(), slab.clone().requires_grad_()
            ex_p, ey_p = sa.softargmax_coords_plain(dp, rp, t, PATCH, row0=row0, height=h,
                                                    ray_row0=first)
            ((ex_p * ab).sum() + (ey_p * cb).sum()).backward()
            e_fwd = max((bex - ex_p).abs().max().item(), (bey - ey_p).abs().max().item())
            rel = max(((bdir - dp.grad).abs().max() / dp.grad.abs().max()).item(),
                      ((brays - rp.grad).abs().max() / rp.grad.abs().max()).item())
            # against the same rows of the whole-image kernel
            vs_whole = max(((x - y).abs().max() / y.abs().max()).item() for x, y in (
                (bex, ex[:, rows]), (bey, ey[:, rows]), (bdir, ddir[:, :, rows])))
            log(f"band rows {row0}-{row0 + BAND_ROWS - 1} (ray slab {first}-{stop - 1}) "
                f"T={t:.3e}: K6f band vs plain {e_fwd:.3e} px (tolerance {TOL_PX[tol]:g}), "
                f"K6b band vs plain {rel:.3e} of the largest (tolerance {TOL_GRAD[tol]:g}); "
                f"ex, ey, d direction vs the whole kernel's rows {vs_whole:.3e} of the largest")
            if not (e_fwd <= TOL_PX[tol] and rel <= TOL_GRAD[tol] and vs_whole <= TOL_BAND_WHOLE
                    and torch.isfinite(bdir).all() and torch.isfinite(brays).all()):
                raise AssertionError("a band form disagrees with its plain version or the "
                                     "whole-image kernel")
            err["fwd"] = max(err["fwd"], e_fwd)
            err["bwd"] = max(err["bwd"], (bdir - dp.grad).abs().max().item(),
                             (brays - rp.grad).abs().max().item())
            whole_err = max(whole_err, vs_whole)
        d_rays = ((summed - drays).abs().max() / drays.abs().max()).item()
        log(f"T={t:.3e}: the bands' d rays summed against the whole d rays: {d_rays:.3e} of "
            f"the largest (tolerance {TOL_BAND_WHOLE:g})")
        if d_rays > TOL_BAND_WHOLE:
            raise AssertionError("the bands' d rays do not sum to the whole kernel's")
        whole_err = max(whole_err, d_rays)
        cases.append(dict(temperature=t, d_rays_vs_whole=d_rays))

    # times of the band at rows 96-191 (its slab 76-191) at the path's temperature
    t = path_temperature
    row0 = BAND_ROWS
    first, stop = sa.ray_slab(row0, BAND_ROWS, h, PATCH)
    db, slab = d[:, :, row0:].contiguous(), r[:, :, first:stop].contiguous()
    ab, cb = a[:, row0:].contiguous(), c[:, row0:].contiguous()
    band = (row0, h, first)
    plane, slab_plane = BAND_ROWS * w * 4, (stop - first) * w * 4
    positions = BAND_ROWS * w * (2 * PATCH + 1) ** 2
    exp_ms = positions / (SM_COUNT * SFU_LANES * max_sm_clock_hz()) * 1e3
    b_fwd = bound_ms(3 * plane + 3 * slab_plane + 4 * plane, FWD_OPS * positions, other=exp_ms)
    b_bwd = bound_ms(3 * plane + 3 * slab_plane + 6 * plane + 3 * plane + 3 * slab_plane,
                     BWD_OPS * positions)
    bex, bey, bm, bs = sa.softargmax_fwd_band_cuda(db, slab, t, PATCH, *band)
    fwd_ms = time_ms(lambda: sa.softargmax_fwd_band_cuda(db, slab, t, PATCH, *band))
    bwd_ms = time_ms(lambda: sa.softargmax_bwd_band_cuda(db, slab, t, PATCH, *band, bex, bey,
                                                         bm, bs, ab, cb))
    with torch.no_grad():
        fwd_plain = time_ms(lambda: sa.softargmax_coords_plain(
            db, slab, t, PATCH, row0=row0, height=h, ray_row0=first), **PLAIN_REPS)
    dp, rp = db.clone().requires_grad_(), slab.clone().requires_grad_()
    ex_p, ey_p = sa.softargmax_coords_plain(dp, rp, t, PATCH, row0=row0, height=h,
                                            ray_row0=first)
    loss = (ex_p * ab).sum() + (ey_p * cb).sum()
    bwd_plain = time_ms(lambda: torch.autograd.grad(loss, (dp, rp), retain_graph=True),
                        **PLAIN_REPS)
    case = f"band rows {row0}-{h - 1} of {h}, ray slab {first}-{stop - 1}, seeded, T={t:.3e}"
    log(f"K6f band at [1,3,{BAND_ROWS},{w}] ({case}): {fwd_ms:.4f} ms (bound {b_fwd[0]:.4f}, "
        f"{b_fwd[1]}; plain {fwd_plain:.3f}); K6b band {bwd_ms:.4f} ms (bound {b_bwd[0]:.4f}; "
        f"plain backward {bwd_plain:.3f})")
    common = dict(case=case, by_case=cases, vs_whole=whole_err, library_ms=None)
    return {
        "softargmax_fwd_band": dict(common, max_abs_err=err["fwd"], ms=fwd_ms,
                                    plain_ms=fwd_plain, bound_ms=b_fwd[0], bound_by=b_fwd[1]),
        "softargmax_bwd_band": dict(common, max_abs_err=err["bwd"], ms=bwd_ms,
                                    plain_ms=bwd_plain, bound_ms=b_bwd[0], bound_by=b_bwd[1]),
    }


def kind_runs(root):
    """Phase 12's runs of tools/hr_2dmesh.py: KIND_ONE_PROCESS and the
    floor's perturbed omnicam steps in one process, then KIND_GRID's on two
    ranks of card 0 in one launch; returns each run's JSON line by label."""
    base = ["--data", "1", "--steps", str(SPACE_KIND_STEPS), "--device", "cuda:0"]
    one = [[recipe, base + ["--recipe", recipe, "--space", "1", "--pack-mode", mode],
            "float32", None] for recipe, mode in KIND_ONE_PROCESS]
    one += [[f"omnicam_floor{seed}", ["--data", "1", "--steps", "1", "--device", "cuda:0",
                                      "--recipe", "omnicam", "--space", "1"], "float32", seed]
            for seed in range(FLOOR_DRAWS)]
    grid = [[f"{recipe}_grid" + ("_bf16" if dtype == "bfloat16" else ""),
             base + ["--recipe", recipe, "--space", "2"], dtype, None]
            for recipe, dtype in KIND_GRID]
    hr_worker(root, "kinds_one_process", one, 1)
    hr_worker(root, "kinds_grid", grid, 2)
    out = {}
    for label, _, _, _ in one + grid:
        out[label] = json.loads((root / f"{label}.json").read_text())
        r = out[label]
        log(f"{label} ({r['model']}, {r['dtype']}, {r['height']}x{r['width']}, space "
            f"{r['space']}, pack mode {r['pack_mode']}): losses {r['losses']}, terms "
            f"{r['terms'][0]}, step {r['step_ms']:.2f} ms, peak MiB by rank "
            f"{[round(x['peak_mib'], 1) for x in r['ranks']]}, launches by rank "
            f"{[{k: v for k, v in x['launches'].items() if v} for x in r['ranks']]}, "
            f"collectives a step {r['ranks'][0]['collectives_per_step']}")
    return out


def space_kinds_phase(device, path_temperature):
    """Phase 12 (see the module docstring); returns its numbers and the band
    forms' kernel numbers."""
    import torch

    t_phase = time.perf_counter()
    log(gpu_name_and_power())
    kernels = band_kernel_phase(device, path_temperature)
    _blocker.clear()
    torch.cuda.empty_cache()
    root = ROOT / "build" / "chip_smoke_space"
    root.mkdir(parents=True, exist_ok=True)
    (ROOT / "build" / "chip_smoke_dist").mkdir(parents=True, exist_ok=True)
    runs = kind_runs(root)
    first = {}
    for label in runs:
        path = root / f"{label}.json.update.pt"
        first[label] = torch.load(path)
        path.unlink()

    def cos(a, b, key):
        u, v = first[a][key].double(), first[b][key].double()
        return float(u @ v / u.norm() / v.norm())

    def rel(x, y):
        return abs(x - y) / abs(y)

    failures = []
    agree = {}
    for recipe, _ in KIND_ONE_PROCESS:
        one, grid = runs[recipe], runs[f"{recipe}_grid"]
        agree[recipe] = dict(
            loss_rel=[rel(x, y) for x, y in zip(grid["losses"], one["losses"])],
            terms_rel={k: rel(grid["terms"][0][k], v) for k, v in one["terms"][0].items()},
            update_cos=cos(f"{recipe}_grid", recipe, "update"),
            grad_cos=cos(f"{recipe}_grid", recipe, "grad"),
            peak_share=[x["peak_mib"] / one["ranks"][0]["peak_mib"] for x in grid["ranks"]],
            step_ratio=grid["step_ms"] / one["step_ms"])
        log(f"{recipe}, space 2 against one process: {agree[recipe]}")
        a = agree[recipe]
        if a["loss_rel"][0] > TOL_SPACE_LOSS or max(a["terms_rel"].values()) > TOL_SPACE_LOSS:
            failures.append(f"{recipe}: the first loss or a term parts from one process's")
        if recipe != "omnicam" and a["update_cos"] < TOL_SPACE_COS:
            failures.append(f"{recipe}: first update's cosine {a['update_cos']}")
    floor = [dict(loss_rel=rel(runs[f"omnicam_floor{s}"]["losses"][0],
                               runs["omnicam"]["losses"][0]),
                  grad_cos=cos(f"omnicam_floor{s}", "omnicam", "grad"))
             for s in range(FLOOR_DRAWS)]
    agree["omnicam"]["floor"] = floor
    log(f"omnicam's floor, one process against itself from weights moved by 1e-7: {floor}; "
        f"the grid's first gradient's cosine {agree['omnicam']['grad_cos']:.6f} (bound "
        f"{TOL_OMNICAM_GRAD_COS})")
    if agree["omnicam"]["grad_cos"] < TOL_OMNICAM_GRAD_COS:
        failures.append(f"omnicam: first gradient's cosine {agree['omnicam']['grad_cos']}")
    for label, r in runs.items():
        want = KIND_LAUNCHES[label if label in KIND_LAUNCHES
                             else label.split("_grid")[0].split("_floor")[0]]
        steps = r["steps"]
        for x in r["ranks"]:
            if x["launches"] != {k: want.get(k, 0) * steps for k in x["launches"]}:
                failures.append(f"{label}: launches {x['launches']}, {want} a step expected")
        if not all(map(math.isfinite, r["losses"])):
            failures.append(f"{label}: a loss is not finite")
    seconds = time.perf_counter() - t_phase
    log(f"phase 12 took {seconds:.1f} s")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
    result = dict(runs=runs, agreement=agree, seconds=seconds,
                  band_kernels={k: {q: v[q] for q in ("ms", "bound_ms", "plain_ms", "vs_whole")}
                                for k, v in kernels.items()})
    return result, kernels


def main(kernels_only=False):
    """Every phase; with ``kernels_only`` (``--kernels``), phases 1 and 2
    alone, printing what they measured as one JSON line and no result line."""
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
    measured.update(warp_jvp_kernel_phase(device))
    measured.update(conv3d_wgrad_kernel_phase(device))
    if kernels_only:
        print(json.dumps({"kernels_alone": measured}))
        return 0
    _blocker.clear()                # the timing's 256 MiB matrix: not a part of any step's memory
    torch.cuda.empty_cache()
    nrs, real = slice_phase(device, cfg)
    measured["softargmax_fwd"]["by_case"].append(real["fwd"])
    measured["softargmax_bwd"]["by_case"].append(real["bwd"])
    kitti_steps = flagship_phase(device, kitti)
    torch.cuda.empty_cache()
    evaluated = eval_phase(device, kitti)
    torch.cuda.empty_cache()
    trained = train_phase(device)
    torch.cuda.empty_cache()
    data = data_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    dist = distributed_phase(device, data)
    gc.collect()
    torch.cuda.empty_cache()
    models = models_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    odometry = odometry_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    space = space_phase()
    gc.collect()
    torch.cuda.empty_cache()
    space_kinds, band_kernels = space_kinds_phase(device, projection_temperature(PROGRESS))
    measured.update(band_kernels)
    omnicam_grid = space_kinds["runs"]["omnicam_grid"]["ranks"][0]["launches"]

    # each kernel's launches are those of the train path it belongs to, as
    # the configs run it (bfloat16): the NRS steps for the soft-argmax (they
    # also launch the bfloat16-image warp, twice a step each), the flagship
    # steps for the warp; the float32-image warp's are those of the float32
    # flagship steps beside them
    nrs_counts, kitti_counts = nrs["bfloat16"]["launches"], kitti_steps["bfloat16"]["launches"]
    meta = {
        "softargmax_fwd": ("softargmax", "packnet_sfm_tpu/ops/pallas_softargmax.py:105", nrs_counts),
        "softargmax_bwd": ("softargmax", "packnet_sfm_tpu/ops/pallas_softargmax.py:159", nrs_counts),
        "warp_fwd": ("warp", "docs/bench_pallas_gather_probe.py:102",
                     kitti_steps["float32"]["launches"]),
        "warp_bwd": ("warp", "docs/bench_pallas_gather_probe.py:102",
                     kitti_steps["float32"]["launches"]),
        "warp_fwd_bf16": ("warp", "docs/bench_pallas_gather_probe.py:102", kitti_counts),
        "warp_bwd_bf16": ("warp", "docs/bench_pallas_gather_probe.py:102", kitti_counts),
        # not a TPU kernel: JAX's forward-mode AD of its warp, taken by the
        # direct alignment; its launches are those of the --refine-direct run
        "warp_jvp": ("warp", "packnet_sfm_tpu/egomotion/alignment.py:65",
                     odometry["direct"]["launches"]),
        # the transpose of the same gather, which JAX's autodiff gives as an
        # XLA scatter-add: no train, eval or odometry path backpropagates into
        # an image, so its launches are those of grid_sample's image
        # gradient in phase 2 (path_launches; 0 in every phase after it)
        "warp_bwd_image": ("warp", "docs/bench_pallas_gather_probe.py:102",
                           measured["warp_bwd_image"]["path_launches"]),
        "warp_bwd_image_bf16": ("warp", "docs/bench_pallas_gather_probe.py:102",
                                measured["warp_bwd_image_bf16"]["path_launches"]),
        # the band forms of K6f/K6b: their launches are those of phase 12's
        # omnicam grid (rank 0, over its SPACE_KIND_STEPS steps)
        "softargmax_fwd_band": ("softargmax", "packnet_sfm_tpu/ops/pallas_softargmax.py:105",
                                omnicam_grid),
        "softargmax_bwd_band": ("softargmax", "packnet_sfm_tpu/ops/pallas_softargmax.py:159",
                                omnicam_grid),
    }
    kernels = []
    for name, (source, replaces, counts) in meta.items():
        m = measured[name]
        entry = dict(name=name, route="cuda", source=f"packnet_sfm_tpu_torch/csrc/{source}.cu",
                     replaces=replaces, launches=counts[name], max_abs_err=m["max_abs_err"],
                     ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                     bound_by=m["bound_by"], library_ms=m.get("library_ms"))
        for extra in ("dtype", "by_shape", "by_case", "library_note", "case", "vs_whole",
                      "bound_with_index_ms", "device_ops"):
            if extra in m:
                entry[extra] = m[extra]
        if name in ("warp_fwd", "warp_bwd"):
            # the float32 image and the bfloat16 one, at the finest scale
            entry["by_case"] = [dict(dtype=measured[key]["dtype"], launches=launches,
                                     **measured[key]["by_shape"][0])
                                for key, launches in ((name, counts[name]),
                                                      (name + "_bf16",
                                                       kitti_counts[name + "_bf16"]))]
        if name.startswith("warp_bwd_image"):
            # none on the train steps of phases 3 and 4
            entry["steps_launches"] = {
                "nrs": nrs_counts[name], "flagship": kitti_counts[name],
                "flagship_float32": kitti_steps["float32"]["launches"][name]}
        # the launches of the real-format runs of phase 7
        entry["data_launches"] = {run: data[run]["launches"][name]
                                  for run in ("kitti", "omnicam", "ddad", "ddad_two_cameras")}
        # phase 8's, by rank
        two = dist["two_ranks"]
        entry["distributed_launches"] = {
            "train_kitti_first_step": [c[name] for c in two["kitti_first_step"]["launches"]],
            "train_omnicam": [r["launches"][name] for r in two["omnicam"]],
            "eval_kitti": [c[name] for c in two["eval"]["launches"]],
            "drain": [c[name] for c in dist["drain"]["launches"]],
            "resume": [c[name] for c in dist["drain"]["resume_launches"]]}
        # phase 9's, by run
        entry["models_launches"] = {run: rec["launches"][name] for run, rec in models.items()
                                    if isinstance(rec, dict)}
        # phase 10's, by odometry run
        entry["odometry_launches"] = {run: odometry[run]["launches"][name]
                                      for run, _ in ODOMETRY_RUNS}
        # phase 11's, by run and rank, over its SPACE_STEPS steps
        entry["space_launches"] = {run: [x["launches"][name] for x in rec["ranks"]]
                                   for run, rec in space["runs"].items()}
        # phase 12's, by run and rank, over each run's steps
        entry["space_kinds_launches"] = {run: [x["launches"][name] for x in rec["ranks"]]
                                         for run, rec in space_kinds["runs"].items()}
        kernels.append(entry)
    # not a TPU kernel: the weight gradient of channel_conv3d, which JAX
    # leaves to XLA's autodiff; its launches a step are counted by the
    # program's spans (engine/spans.py), one a differentiated call
    m = measured["channel_conv3d_wgrad"]
    kernels.append(dict(name="channel_conv3d_wgrad", route="cuda",
                        source="packnet_sfm_tpu_torch/csrc/fold_conv.cu", replaces=None,
                        **{k: m[k] for k in ("max_abs_err", "max_bf16_spacings", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms", "dtype",
                                             "by_shape")}))
    print(json.dumps({"steps": {"nrs": nrs, "flagship": kitti_steps}}))
    print(json.dumps({"eval": evaluated}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"data": data}))
    print(json.dumps({"distributed": dist}))
    print(json.dumps({"models": models}))
    print(json.dumps({"odometry": odometry}))
    print(json.dumps({"space": space}))
    print(json.dumps({"space_kinds": space_kinds}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels"]))
