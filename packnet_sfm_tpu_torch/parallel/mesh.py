"""Multi-process data parallelism (port of ``packnet_sfm_tpu/parallel/
mesh.py``) over ``torch.distributed``: one process a rank, NCCL between
cards, gloo on the CPU.

The JAX package runs one jit over a device mesh and a globally sharded
batch. Here every rank holds its own rows of the global batch (its loader's
shard) and its own replica of the model; ``engine/train.make_train_step``
averages the gradients across ranks with ``DistributedDataParallel``, and
the statistics that JAX takes over the global batch (BatchNorm's mean and
variance, the photometric clip's mean and std) are summed across ranks
with ``all_reduce_sum``, through which gradients flow. So ``make_mesh`` and
``shard_batch`` have no counterpart: the rows already are where they are
computed.

The (data x space) grid, ``make_mesh_2d``: rank r is data rank r // S and
space rank r % S of S, as the JAX package lays its devices out
(``reshape(n // S, S)``). The ranks of a space group hold the same samples
(their data rank's) and each runs the depth network on one band of their
rows (``parallel/spatial.py``); ``engine/train.make_train_step`` and
``make_eval_step`` take the grid, and ``gather_rows`` (the counterpart of
``host_local_rows``) puts a band-sharded output back together.

Host values (flags, metric rows, strings) travel over a gloo group beside
the NCCL one, since NCCL takes only device tensors. Without a process
group, ``process_index()`` is 0, ``process_count()`` 1 and every
collective here is the identity, as in the JAX package without
``jax.distributed``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from packnet_sfm_tpu_torch.parallel.spatial import Band

_groups: dict = {}          # 'host': the gloo group for host values, once initialized


def init_distributed(backend: Optional[str] = None, device="cuda",
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group of this rank and return its device.

    Rank, world size and local rank come from the environment as
    ``torch.distributed.run`` sets them (RANK, WORLD_SIZE, LOCAL_RANK);
    ``init_method`` defaults to its ``env://`` (MASTER_ADDR, MASTER_PORT),
    and may be a ``file://`` path shared by the ranks. ``device`` 'cuda'
    gives rank ``LOCAL_RANK`` the card ``cuda:LOCAL_RANK``, and raises where
    there is no such card: ranks never share a card unless one is named
    (``cuda:0`` for every rank), which NCCL refuses ("Duplicate GPU
    detected"), so that takes ``backend='gloo'``. ``backend`` defaults to
    NCCL on the card and gloo on the CPU. Joining a group that is already
    initialized only resolves the device.
    """
    from packnet_sfm_tpu_torch.device import resolve_device

    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    if "host" not in _groups:
        _groups["host"] = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
    return dev


def shutdown() -> None:
    """Leave the process group (at the end of a run)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _groups.clear()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _host_group():
    return _groups.get("host", dist.group.WORLD)


def batch_group():
    """The group over which batch statistics are taken: the default group
    where there is more than one rank, else None (the local batch is the
    global one)."""
    return dist.group.WORLD if process_count() > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks'
    gradients: the global loss is the mean of the ranks' losses, each of
    which depends on every rank's rows through the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (differentiable)."""
    return _AllReduceSum.apply(x, group)


def global_mean_var(x: torch.Tensor, dims, group):
    """The mean and the biased (ddof 0) variance of ``x`` over ``dims`` and
    over the ranks of ``group``, in two passes: the global mean, then the
    global mean of the squared deviations from it. Every rank must hold as
    many elements as the others. Returns (mean, var) with the reduced axes
    kept as size 1; both carry gradients to ``x`` on every rank."""
    total = all_reduce_sum(x.sum(dims, keepdim=True), group)
    n = x.numel() // total.numel() * dist.get_world_size(group)
    mean = total / n
    centered = x - mean
    var = all_reduce_sum((centered * centered).sum(dims, keepdim=True), group) / n
    return mean, var


def all_reduce_host_sum(tree):
    """Sum host-local numpy arrays (a dict or list of them, nested) across
    all processes, in float64 over the gloo group; every process gets the
    global sum. One process: the identity."""
    if process_count() <= 1:
        return tree
    if isinstance(tree, dict):
        return {k: all_reduce_host_sum(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(all_reduce_host_sum(v) for v in tree)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float64))
    dist.all_reduce(t, group=_host_group())
    return t.numpy().astype(arr.dtype, copy=False)


def any_process_flag(flag: bool) -> bool:
    """True iff ``flag`` is set on any process (one process: the identity).

    Agrees on preemption: a SIGTERM lands on one process, but every process
    must leave the train loop at the same batch boundary, or the others
    wait for a step that it never joins. Every process must call this at
    the same point."""
    if process_count() <= 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int64)
    dist.all_reduce(t, group=_host_group())
    return bool(t.item() > 0)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if process_count() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group())
    return box[0]


def barrier() -> None:
    """Wait until every process gets here."""
    if process_count() > 1:
        dist.barrier(group=_host_group())


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (data x space) grid of the ranks: this rank's indices, the group of
    its data rank (``space_group``: the ranks that share its samples) and
    ``grad_group``, all ranks, over which the gradients are averaged (a
    group of its own, so that the gradient buckets never interleave with
    the exchanges of the space group or the statistics of the default
    one)."""

    data_count: int
    space_count: int
    data_index: int
    space_index: int
    space_group: Any = None
    grad_group: Any = None

    def band(self) -> Optional[Band]:
        """This rank's band (``parallel/spatial.Band``), or None without a
        space axis."""
        if self.space_count <= 1:
            return None
        return Band(self.space_group, self.space_index, self.space_count)


def make_mesh_2d(spatial_shards: int) -> Mesh2D:
    """The (data, space) grid over the whole process group:
    ``spatial_shards`` ranks a space group, world // spatial_shards data
    ranks. Every rank must call it, in the same order as its other
    collectives. Raises ``ValueError`` where the world size is not
    divisible by ``spatial_shards``, as the JAX package does."""
    n = process_count()
    if spatial_shards < 1 or n % spatial_shards:
        raise ValueError(f"{n} devices not divisible by {spatial_shards}")
    data_count, rank = n // spatial_shards, process_index()
    grid = dict(data_count=data_count, space_count=spatial_shards,
                data_index=rank // spatial_shards, space_index=rank % spatial_shards)
    if n == 1:
        return Mesh2D(**grid)
    # dist.new_group is collective: every rank makes every group, in one order
    spaces = [dist.new_group(list(range(d * spatial_shards, (d + 1) * spatial_shards)))
              for d in range(data_count)]
    grad = dist.new_group(list(range(n)))
    return Mesh2D(**grid, space_group=spaces[grid["data_index"]], grad_group=grad)


def gather_rows(x: torch.Tensor, grid: Optional[Mesh2D], dim: int = 1) -> torch.Tensor:
    """The whole of a band-sharded tensor (this rank's band of rows on
    ``dim``), gathered from the bands of its space group in row order; the
    identity without a space axis (the counterpart of the JAX package's
    ``host_local_rows``: this data rank's samples, whole)."""
    if grid is None or grid.space_count <= 1:
        return x
    parts = [torch.empty_like(x) for _ in range(grid.space_count)]
    dist.all_gather(parts, x.contiguous(), group=grid.space_group)
    return torch.cat(parts, dim)
