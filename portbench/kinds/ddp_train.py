"""The data-parallel train kind: the program's train step (``engine/train.
make_train_step``) on the configuration's ``train`` recipe in ``ranks``
processes, one a card (NCCL; gloo on the CPU), as ``torch.distributed.run``
lays a job out, and its check against the plain reference on the global
batch.

Rank 0 is the harness's own process; it builds the program's kernels, then
starts ranks 1 to ``ranks`` - 1 (``python -m portbench.kinds.ddp_train
--worker <job>``, from the checkout's root). Every rank joins the process
group through ``parallel/mesh.init_distributed`` (its rank, world size and
local rank in the environment, the group's address a free localhost port)
and builds the model, the weights from the seed and the step as the train
kind does; ``make_train_step`` wraps the loss in ``DistributedDataParallel``.
Each rank makes the global pool from the seed (``batch`` x ``ranks`` rows a
batch) and trains on its own rows, rank r on rows r B to (r + 1) B - 1.

Set-up drives every rank through the first ``check_steps`` steps and takes
the train kind's readings there; the loss is the ranks' mean (an
all-reduce of the readings, outside the steps), the first gradient Adam's
first moment after one all-reduced step. After them each rank counts the
elements of its weights that differ from rank 0's (``rank_weight_mismatch``,
summed over the ranks: 0 where every rank holds rank 0's bits).

From then on rank 0 leads: each of its step calls first posts the step's
index to a TCP store, and the other ranks take the same step as soon as
they read it, so every window of rank 0 (measured, traced, recorded) has
its steps taken by every rank, with no synchronize added to a step. Rank 0
checks at each step that the other ranks still run. ``free`` posts the end:
each rank reports its peak device memory (printed on standard error), and
leaves the group. The reference then takes the first steps on the global
batch, as the train kind's does for a cell of ``batch`` x ``ranks``
samples on one card.
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from portbench.kinds.train import TrainCell

ROOT = Path(__file__).resolve().parents[2]
STORE_TIMEOUT = datetime.timedelta(seconds=900)
JOIN_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: [c[lo:hi] for c in v] if isinstance(v, list) else v[lo:hi]
            for k, v in batch.items()}


def _load_function(path: str, name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_ddp_{Path(path).stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


class DdpTrainCell(TrainCell):
    """One rank's program side; on rank 0, ``step(i)`` has every rank train
    on its rows of the global pool's batch i."""

    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int, device,
                 make_pool, fault: Optional[str] = None, rank: int = 0,
                 job: Optional[dict] = None):
        self.rank, self.world = rank, int(traffic["ranks"])
        self.global_traffic = dict(traffic, batch=traffic["batch"] * self.world)
        self.workers, self._sent, self._lead = [], 0, False
        self._env = {}
        if rank == 0:
            job = self._start_workers(config, traffic, cell, seed, device, make_pool, fault)
        try:
            self._join(job, device)
            full = {}

            def my_rows(_traffic, seed_, device_):
                full["pool"] = make_pool(self.global_traffic, seed_, device_)
                b = traffic["batch"]
                return [_rows(batch, rank * b, (rank + 1) * b) for batch in full["pool"]]

            super().__init__(config, traffic, cell, seed, device, my_rows, fault)
            self.global_pool = full["pool"] if rank == 0 else None
        except BaseException:
            self._stop_workers()
            self._restore_env()
            from packnet_sfm_tpu_torch.parallel import mesh

            mesh.shutdown()
            raise
        self._lead = rank == 0

    # ---- the ranks ------------------------------------------------------------
    def _start_workers(self, config, traffic, cell, seed, device, make_pool, fault) -> dict:
        if device.type == "cuda":
            from packnet_sfm_tpu_torch.ops import _cuda

            _cuda.build()           # once, before the ranks start; they load it
        job = {"config": config, "traffic": traffic, "cell": cell, "seed": seed,
               "fault": fault, "device": device.type,
               "make_pool": [make_pool.__code__.co_filename, make_pool.__name__],
               "group_port": _free_port(), "store_port": _free_port()}
        env = dict(os.environ, WORLD_SIZE=str(self.world),
                   PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT),
                                                            os.environ.get("PYTHONPATH")])))
        for r in range(1, self.world):
            self.workers.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.kinds.ddp_train", "--worker", json.dumps(job)],
                cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=sys.stderr.fileno()))
        atexit.register(self._stop_workers)     # no rank outlives a run that fails
        return job

    def _join(self, job: dict, device) -> None:
        import torch.distributed as dist

        from packnet_sfm_tpu_torch.parallel import mesh

        self.store = dist.TCPStore("localhost", job["store_port"], self.world,
                                   is_master=self.rank == 0, timeout=STORE_TIMEOUT)
        if self.rank == 0:          # the harness's process: its environment put back in free
            for key, value in (("RANK", "0"), ("LOCAL_RANK", "0"),
                               ("WORLD_SIZE", str(self.world))):
                self._env[key] = os.environ.get(key)
                os.environ[key] = value
        mesh.init_distributed(device=str(device) if device.type == "cuda" else "cpu",
                              init_method=f"tcp://localhost:{job['group_port']}")

    def _stop_workers(self) -> None:
        for p in self.workers:
            if p.poll() is None:
                p.kill()
            p.wait()
        self.workers = []

    def _post(self, command: str) -> None:
        for p in self.workers:
            if p.poll() is not None:
                raise RuntimeError(f"a rank exited with code {p.returncode}")
        self.store.set(f"command{self._sent}", command)
        self._sent += 1

    def follow(self) -> None:
        """A rank other than 0: take the steps rank 0 posts, until the end."""
        n = 0
        while True:
            command = self.store.get(f"command{n}").decode()
            n += 1
            if command == "end":
                break
            TrainCell.step(self, int(command))
        self._leave()

    def _leave(self) -> None:
        from packnet_sfm_tpu_torch.parallel import mesh

        cuda = self.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        self.store.set(f"peak{self.rank}", str(peak))
        mesh.barrier()
        TrainCell.free(self)
        mesh.shutdown()

    # ---- the step that the windows drive ---------------------------------------
    def step(self, i: int) -> None:
        if self._lead:
            self._post(str(i))
        super().step(i)

    def images_per_step(self) -> int:
        return self.global_traffic["batch"]

    def _first_steps(self) -> None:
        import torch.distributed as dist

        super()._first_steps()
        losses = torch.tensor(self.losses, dtype=torch.float64, device=self.device)
        dist.all_reduce(losses)
        self.losses = (losses / self.world).tolist()
        differ = torch.zeros((), dtype=torch.float64, device=self.device)
        for p in self.model.parameters():
            mine = p.detach().contiguous()
            ranks0 = mine.clone()
            dist.broadcast(ranks0, 0)
            differ += (mine.view(torch.int32) != ranks0.view(torch.int32)).sum()
        dist.all_reduce(differ)
        self.rank_weight_mismatch = float(differ)

    def readings(self):
        return (*super().readings(), self.rank_weight_mismatch)

    def compare(self, got, want):
        """The train kind's numbers on the global batch, and
        ``rank_weight_mismatch``."""
        out = TrainCell.compare(got[:3], want)
        out["rank_weight_mismatch"] = got[3] if len(got) > 3 else 0.0
        return out

    def free(self) -> None:
        """The end of the run's steps: every rank leaves the group."""
        self._lead = False
        self._post("end")
        self._leave()
        for p in self.workers:
            p.wait(timeout=JOIN_TIMEOUT_S)
        peaks = [int(self.store.get(f"peak{r}")) / 2 ** 20 for r in range(self.world)]
        print(f"portbench.ddp_train: peak MiB by rank {peaks}", file=sys.stderr, flush=True)
        atexit.unregister(self._stop_workers)
        self.workers = []
        del self.store
        self._restore_env()

    def _restore_env(self) -> None:
        for key, value in self._env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self._env = {}

    # ---- the reference: the global batch -----------------------------------------
    def reference(self, dtype=torch.float64, cast=None, tf32: bool = False):
        self.pool, self.traffic = self.global_pool, self.global_traffic
        return super().reference(dtype, cast, tf32)


def build(config, traffic, cell, seed, device, make_pool, fault=None) -> DdpTrainCell:
    return DdpTrainCell(config, traffic, cell, seed, device, make_pool, fault)


def _worker(job: dict) -> None:
    rank = int(os.environ["RANK"])
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"])) if job["device"] == "cuda"
              else torch.device("cpu"))
    if device.type == "cpu":        # ranks sharing the host's cores
        torch.set_num_threads(1)
    spec = job["cell"]
    torch.backends.cudnn.allow_tf32 = spec["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]["matmul"]
    cell = DdpTrainCell(job["config"], job["traffic"], spec, job["seed"], device,
                        _load_function(*job["make_pool"]), job["fault"], rank=rank, job=job)
    cell.follow()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="a rank of the data-parallel train kind")
    ap.add_argument("--worker", required=True, help="the job, as JSON")
    _worker(json.loads(ap.parse_args().worker))
