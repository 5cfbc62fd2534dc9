"""Multi-process data parallelism (port of ``packnet_sfm_tpu/parallel/
mesh.py``) over ``torch.distributed``: one process a rank, NCCL between
cards, gloo on the CPU.

The JAX package runs one jit over a device mesh and a globally sharded
batch. Here every rank holds its own rows of the global batch (its loader's
shard) and its own replica of the model; ``engine/train.make_train_step``
averages the gradients across ranks with ``DistributedDataParallel``, and
the statistics that JAX takes over the global batch (BatchNorm's mean and
variance, the photometric clip's mean and std) are summed across ranks
with ``all_reduce_sum``, through which gradients flow. So ``make_mesh``,
``shard_batch`` and ``host_local_rows`` have no counterpart: the rows
already are where they are computed. The data x space mesh
(``make_mesh_2d``) is not ported (ROADMAP.md §1 item 5b).

Host values (flags, metric rows, strings) travel over a gloo group beside
the NCCL one, since NCCL takes only device tensors. Without a process
group, ``process_index()`` is 0, ``process_count()`` 1 and every
collective here is the identity, as in the JAX package without
``jax.distributed``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

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
