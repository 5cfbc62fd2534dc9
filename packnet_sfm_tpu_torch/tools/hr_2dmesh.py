"""The high-resolution train step on a (data x space) grid of processes (the
counterpart of the JAX package's ``docs/bench_hr_2dmesh.py``)::

    python -m packnet_sfm_tpu_torch.tools.hr_2dmesh [--recipe hr] [--data 1]
        [--space 2] [--steps 3] [--device cuda] [--backend nccl|gloo]
        [--pack-mode auto] [--out FILE]

``--recipe`` picks one of ``RECIPES``, each a fixed model at a fixed size,
float32, random weights from seed 0, one sample a data rank, on synthetic
noise frames drawn from seed 0 (as ``_synthetic_batch``: intrinsics fx =
fy = 0.6 W), no flip:
- ``hr``: the JAX package's HR recipe (``__graft_entry__._flagship_model``,
  as ``docs/bench_hr_2dmesh.py`` runs it): SelfSupModel, PackNet01-1A +
  PoseNet at full width, remat on, two contexts, at 384x1280;
- ``hr_velsup``: the same networks as VelSupModel (velocity weight 0.1),
  the model of the reference's published HR result, with ``pose_context``
  drawn from the seed;
- ``omnicam``: configs/train_omnicam.yaml's model (GenericSelfSupModel,
  RaySurfaceResNet-18 + PoseNet, the NRS loss) at 384x384, progress 0.5;
- ``semisup``: PackNet01-1A + PoseNet as SemiSupModel (weight 0.9,
  ``sparse-berhu``) at 192x640, with a synthetic ground-truth depth drawn
  from the seed (a fifth of the pixels valid, as projected lidar leaves).

``torch.distributed.run --standalone`` starts data x space processes, one a
rank, on a grid of ``--space`` ranks a space group (``parallel/mesh.
make_mesh_2d``): data rank d takes sample d of the global batch of
``--data``, and each rank of its space group runs the depth network on its
band of its rows. One rank (--data 1 --space 1) runs the plain step in one
process, without a group. ``--pack-mode`` builds PackNet's pack layers in
that mode (``ops/fold_conv.fused_pack_conv``); on a band they take
'two_step' whatever it says, as the JAX package's do on a space axis.

Each rank sets the port's launch counters to 0, takes ``--steps`` Adam
steps and reads them: the JSON line (and ``--out``) holds the losses and
the loss terms of every step, the step's ms (after the first, which builds
the cuDNN plans; the slowest rank's), each rank's peak MiB on the card, its
kernel launches (the soft-argmax's band forms among them) and its
exchanges and reductions a step (``parallel/spatial.collectives``), and,
with ``--out``, ``<out>.update.pt``: rank 0's update of the first step (the
weights after it minus before) and its gradient, for a comparison of two
runs. Ranks get ``cuda:LOCAL_RANK`` over NCCL; ``--backend gloo --device
cuda:0`` puts every rank on one card (NCCL refuses that). TF32 is off, as
for every float32 figure of the port. From Python, ``run_steps(args,
device, grid, dtype=torch.bfloat16)`` runs a recipe under the bfloat16
policy (``engine/train.cast_batch``) in a process group made once for
several runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from packnet_sfm_tpu_torch.core.config import OMNICAM

HR = {"model": {"name": "SelfSupModel",
                "depth_net": {"name": "PackNet01", "version": "1A", "remat": True},
                "pose_net": {"name": "PoseNet"}, "loss": {"flip_lr_prob": 0.0}}}


RECIPES = {
    "hr": dict(config=HR, height=384, width=1280, progress=0.0),
    "hr_velsup": dict(config={"model": dict(HR["model"], name="VelSupModel",
                                            loss={"flip_lr_prob": 0.0,
                                                  "velocity_loss_weight": 0.1})},
                      height=384, width=1280, progress=0.0),
    "omnicam": dict(config={"model": OMNICAM["model"]}, height=384, width=384, progress=0.5),
    "semisup": dict(config={"model": {"name": "SemiSupModel",
                                      "depth_net": {"name": "PackNet01", "version": "1A"},
                                      "pose_net": {"name": "PoseNet"},
                                      "loss": {"flip_lr_prob": 0.0,
                                               "supervised_loss_weight": 0.9,
                                               "supervised_method": "sparse-berhu"}}},
                    height=192, width=640, progress=0.0),
}
BATCH = 1           # samples a data rank
SEED = 0
DEPTH_DENSITY = 0.2     # valid pixels of the semisup recipe's ground truth


def synthetic_batch(b: int, h: int, w: int, n_ctx: int = 2, seed: int = 0) -> dict:
    """``b`` noise frames with ``n_ctx`` contexts and intrinsics, from ``seed``
    (the JAX package's ``__graft_entry__._synthetic_batch``), then drawn
    after them from the same generator: the contexts' poses ('pose_context',
    translations of 0.2-1.5 m along each axis) and a ground-truth depth
    ('depth', 1-80 m on DEPTH_DENSITY of the pixels, 0 elsewhere)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    ctx = [rng.uniform(size=(b, h, w, 3)).astype(np.float32) for _ in range(n_ctx)]
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 0.6 * w
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2 - 0.5, h / 2 - 0.5, 1.0
    poses = []
    for _ in range(n_ctx):
        T = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
        T[:, :3, 3] = rng.uniform(0.2, 1.5, size=(b, 3)).astype(np.float32)
        poses.append(T)
    depth = rng.uniform(1.0, 80.0, size=(b, h, w, 1)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) >= DEPTH_DENSITY] = 0.0
    return {"rgb": img, "rgb_context": ctx, "intrinsics": K, "pose_context": poses,
            "depth": depth}


def run_rank(args) -> dict:
    """This rank's steps (``run_steps``), in a process group where the
    launcher made one."""
    import torch

    from packnet_sfm_tpu_torch.parallel import mesh

    grouped = "RANK" in os.environ
    device = (mesh.init_distributed(args.backend, args.device) if grouped
              else torch.device(args.device))
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        return run_steps(args, device, mesh.make_mesh_2d(args.space) if grouped else None)
    finally:
        if grouped:
            mesh.shutdown()


def run_steps(args, device, grid=None, dtype=None, perturb=None) -> dict:
    """This rank's steps of ``args.recipe`` on ``device``, on its band of
    ``grid`` (a ``parallel/mesh.Mesh2D``; None: one process); ``dtype``
    bfloat16 builds the networks in it and casts the batch's images, as
    ``arch.dtype`` does; ``perturb``, a seed, moves every weight by a
    relative 1e-7 first (the port's own floor of a chaotic objective)."""
    import torch

    from packnet_sfm_tpu_torch.core.config import config_from_dict
    from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
    from packnet_sfm_tpu_torch.nn.packnet import PackNet01
    from packnet_sfm_tpu_torch.ops import softargmax, warp
    from packnet_sfm_tpu_torch.parallel import mesh, spatial

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_index = grid.data_index if grid is not None else 0
    recipe = RECIPES[args.recipe]
    height, width = recipe["height"], recipe["width"]
    cfg = config_from_dict(recipe["config"])
    model = setup_model(cfg.model, device=device, seed=SEED, dtype=dtype)
    if args.pack_mode != "auto":        # the same weights, in pack layers of that mode
        if not isinstance(model.depth_net, PackNet01):
            raise ValueError(f"--pack-mode {args.pack_mode}: recipe {args.recipe} has no "
                             "pack layers")
        net = PackNet01(version="A", remat=model.depth_net.remat, pack_mode=args.pack_mode,
                        dtype=dtype)
        net.load_state_dict(model.depth_net.state_dict())
        model.depth_net = net.to(device)
    if perturb is not None:
        gen = torch.Generator().manual_seed(perturb)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen).to(p.device))
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 1000)
    step = make_train_step(model, optimizer, scheduler, mesh=grid,
                           compute_dtype=dtype or torch.float32)
    batch = synthetic_batch(args.data * BATCH, height, width, seed=SEED)
    lo = data_index * BATCH
    batch = {k: [c[lo:lo + BATCH] for c in v] if isinstance(v, list)
             else v[lo:lo + BATCH] for k, v in batch.items()}
    start = [p.detach().clone() for p in model.parameters()]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mesh.barrier()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warp.reset_launch_counts()
    softargmax.reset_launch_counts()
    spatial.reset_counts()
    losses, terms, times = [], [], []
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        acc = step(zero_metrics(device), batch, recipe["progress"])
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(acc["loss"][0]))
        terms.append({k: float(v[0]) for k, v in acc.items() if k != "loss" and float(v[1])})
        if i == 0 and args.out and mesh.process_index() == 0:
            params = list(model.parameters())
            torch.save({"update": torch.cat([(p.detach() - s).flatten().cpu()
                                             for p, s in zip(params, start)]),
                        # a scale the loss does not read leaves its head without one
                        "grad": torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                                           .flatten().cpu() for p in params])},
                       args.out + ".update.pt")
        start = None
    steady = times[1:] or times
    rank = dict(rank=mesh.process_index(), data_index=data_index,
                space_index=grid.space_index if grid is not None else 0,
                peak_mib=(torch.cuda.max_memory_allocated(device) / 2 ** 20
                          if device.type == "cuda" else None),
                launches=dict(softargmax.launch_counts, **softargmax.band_launch_counts,
                              **warp.launch_counts, **warp.bf16_launch_counts),
                collectives_per_step={k: v / args.steps for k, v in spatial.collectives.items()},
                step_ms=1e3 * sum(steady) / len(steady))
    ranks = [mesh.broadcast_object(rank, src=r) for r in range(mesh.process_count())]
    result = dict(recipe=args.recipe, model=cfg.model.name,
                  dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
                  data=args.data, space=args.space, batch=BATCH,
                  pack_mode="two_step" if grid is not None and grid.space_count > 1
                  else args.pack_mode,
                  height=height, width=width, steps=args.steps, losses=losses, terms=terms,
                  step_ms=max(r["step_ms"] for r in ranks), ranks=ranks,
                  device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                          else "cpu"),
                  backend=torch.distributed.get_backend() if grid is not None else None,
                  parameters=sum(p.numel() for p in model.parameters()))
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", default="hr", choices=sorted(RECIPES))
    p.add_argument("--data", type=int, default=1)
    p.add_argument("--space", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="default: nccl on cards, gloo on the CPU")
    p.add_argument("--pack-mode", default="auto", choices=("auto", "fused", "two_step"))
    p.add_argument("--out", default=None, help="write the JSON line here too")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    world = args.data * args.space
    if args.worker or world == 1:
        result = run_rank(args)
        if "RANK" not in os.environ or int(os.environ["RANK"]) == 0:
            line = json.dumps(result)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(line + "\n")
            print(line, flush=True)
        return 0
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), "-m", "packnet_sfm_tpu_torch.tools.hr_2dmesh", "--worker",
           *(argv if argv is not None else sys.argv[1:])]
    return subprocess.run(cmd).returncode


if __name__ == "__main__":
    sys.exit(main())
