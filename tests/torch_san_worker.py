"""One rank of the two-rank MaskedBatchNorm case of tests/test_torch_san.py,
launched by it with ``torch.distributed.run --standalone --nproc_per_node
2``; imports only the port, torch and numpy.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_san_worker.py <data dir>

The test writes the global batch of sparse depths (``depth.npz``), the
loss weights a level (``weights.npz``) and the starting weights of a
narrow SparseDepthEncoder (``state0.pt``) into <data dir>. Each rank joins
the gloo group on the CPU and takes a train-mode forward of the encoder on
its half of the batch, and the gradient of sum over levels of
sum(feature * weight) with the ranks' gradients summed; then the same with
the batch statistics taken over its own rows only (the control). It
writes its features, running statistics and gradients to
<data dir>/rank<r>.pt.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from packnet_sfm_tpu_torch.nn import sparse
from packnet_sfm_tpu_torch.parallel import mesh

CHANNELS = (8, 16)


def run(data, rank, world):
    depth = torch.from_numpy(np.load(os.path.join(data, "depth.npz"))["depth"])
    weights = np.load(os.path.join(data, "weights.npz"))
    n = depth.shape[0] // world
    rows = depth[rank * n:(rank + 1) * n].permute(0, 3, 1, 2)
    enc = sparse.SparseDepthEncoder(CHANNELS)
    enc.load_state_dict(torch.load(os.path.join(data, "state0.pt")), strict=True)
    enc.train()
    feats = enc(rows)
    loss = sum((f * torch.from_numpy(weights[f"w{i}"][rank * n:(rank + 1) * n]).permute(
        0, 3, 1, 2)).sum() for i, f in enumerate(feats))
    loss.backward()
    grads = {}
    for name, p in enc.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        grads[name] = g
    stats = {k: v.clone() for k, v in enc.state_dict().items() if "running" in k}
    return dict(feats=[f.detach().permute(0, 2, 3, 1) for f in feats], stats=stats,
                grads=grads)


def main():
    data = sys.argv[1]
    mesh.init_distributed(device="cpu")
    rank, world = mesh.process_index(), mesh.process_count()
    out = {"global": run(data, rank, world)}
    # the control: batch statistics over this rank's rows alone
    sparse.batch_group = lambda: None
    out["local"] = run(data, rank, world)
    torch.save(out, os.path.join(data, f"rank{rank}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    main()
