"""Data-parallel scaling of the train step (port of ``packnet_sfm_tpu/
parallel/scaling.py``)::

    python -m packnet_sfm_tpu_torch.parallel.scaling

For each world size n, ``torch.distributed.run`` starts n processes, one a
rank (``cuda:LOCAL_RANK`` over NCCL on the card, gloo on the CPU), which
take the train step of ``configs/train_kitti.yaml`` as written (PackNet01-1A
+ PoseNet, bfloat16, 192x640; or the given config) at a fixed batch a rank,
on synthetic rows of their own, and time ``steps`` steps after ``warmup``:

    imgs_per_sec(n) = per_rank_batch * n * steps / (the slowest rank's time)
    efficiency(n)   = imgs_per_sec(n) / (n * imgs_per_sec(1))

One JSON line per world size, at the world sizes this machine has cards
for (``measure_scaling`` takes others, and the CPU, where it checks the
plumbing, not speed).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional


def measure_scaling(world_sizes: Optional[List[int]] = None, per_rank_batch: int = 4,
                    height: int = 192, width: int = 640, steps: int = 6, warmup: int = 2,
                    device: str = "cuda", config: Optional[Dict] = None,
                    timeout: float = 900) -> List[Dict]:
    """Train-step throughput at each world size; returns [{'world',
    'images_per_step', 'imgs_per_sec', 'imgs_per_sec_per_rank', 'efficiency',
    'step_ms', 'device', 'kind', 'backend'}]. ``config`` is a config dict
    (default ``core/config.KITTI``)."""
    import torch

    if world_sizes is None:
        count = torch.cuda.device_count() if device != "cpu" else 1
        world_sizes = [n for n in (1, 2, 4, 8) if n <= count]
    results, base = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for n in world_sizes:
            out = os.path.join(tmp, f"world{n}.json")
            job = dict(per_rank_batch=per_rank_batch, height=height, width=width, steps=steps,
                       warmup=warmup, device=device, config=config, out=out)
            job_path = os.path.join(tmp, f"job{n}.json")
            with open(job_path, "w") as f:
                json.dump(job, f)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(n), "-m", "packnet_sfm_tpu_torch.parallel.scaling",
                   "--worker", job_path]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"world {n} exited with {proc.returncode}:\n"
                                   f"{(proc.stdout + proc.stderr)[-4000:]}")
            with open(out) as f:
                row = json.load(f)
            base = base if base is not None else row["imgs_per_sec"]
            row["efficiency"] = row["imgs_per_sec"] / (n * base)
            results.append(row)
    return results


def synthetic_batch(rng, b: int, h: int, w: int) -> Dict:
    """A host batch of ``b`` noise frames with two contexts and intrinsics."""
    import numpy as np

    img = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 0.58 * w
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2, h / 2, 1.0
    return {"rgb": img, "rgb_context": [np.roll(img, 2, axis=2), np.roll(img, -2, axis=2)],
            "intrinsics": K}


def time_steps(config: Optional[Dict], device, per_rank_batch: int, height: int, width: int,
               steps: int, warmup: int, seed: int = 0) -> float:
    """Seconds that ``steps`` train steps of ``config`` (default
    ``core/config.KITTI``) take on ``device`` after ``warmup``, on a
    synthetic batch drawn from ``seed``; in a process group, the step is
    the distributed one (``engine/train.make_train_step``)."""
    import numpy as np
    import torch

    from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict
    from packnet_sfm_tpu_torch.engine.factory import compute_dtype, make_optimizer, setup_model
    from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
    from packnet_sfm_tpu_torch.parallel import mesh

    cfg = config_from_dict(config or KITTI)
    dtype = compute_dtype(cfg)
    model = setup_model(cfg.model, device=device, dtype=dtype)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler, 1000)
    step = make_train_step(model, optimizer, scheduler, compute_dtype=dtype or torch.float32)
    batch = synthetic_batch(np.random.default_rng(seed), per_rank_batch, height, width)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    acc = zero_metrics(device)
    for _ in range(warmup):
        acc = step(acc, batch, 0.0)
    sync()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        acc = step(acc, batch, 0.0)
    sync()
    dt = time.perf_counter() - t0
    if not np.isfinite(float(acc["loss"][0])):
        raise RuntimeError("a non-finite loss")
    return dt


def _worker(job_path: str) -> None:
    """One rank: ``time_steps`` at the job's size; rank 0 writes the row
    with the slowest rank's time."""
    import torch

    from packnet_sfm_tpu_torch.parallel import mesh

    with open(job_path) as f:
        job = json.load(f)
    device = mesh.init_distributed(device=job["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    rank, world = mesh.process_index(), mesh.process_count()
    dt = time_steps(job["config"], device, job["per_rank_batch"], job["height"], job["width"],
                    job["steps"], job["warmup"], seed=rank)
    slowest = max(mesh.broadcast_object(dt, src=r) for r in range(world))
    if rank == 0:
        images = job["per_rank_batch"] * world
        row = dict(world=world, images_per_step=images,
                   imgs_per_sec=images * job["steps"] / slowest,
                   imgs_per_sec_per_rank=job["per_rank_batch"] * job["steps"] / slowest,
                   step_ms=slowest / job["steps"] * 1e3, device=device.type,
                   kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   backend=torch.distributed.get_backend())
        with open(job["out"], "w") as f:
            json.dump(row, f)
    mesh.shutdown()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:             # one rank of measure_scaling's launch
        _worker(argv[1])
        return
    for row in measure_scaling():
        print(json.dumps(row))


if __name__ == "__main__":
    main()
