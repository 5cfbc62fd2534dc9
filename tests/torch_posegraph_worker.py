"""One rank of the two-rank pose graph in tests/test_torch_egomotion.py,
launched with ``torch.distributed.run --standalone --nproc_per_node 2``;
imports only the port, torch and numpy.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_posegraph_worker.py <data dir>

Reads <data dir>/graph.npz (T_init, the edges i, j, Z, w and the config's
num_iterations and optimize_scales), joins the gloo group on the CPU, runs
``optimize_pose_graph_sharded`` on the whole edge set and writes what it
got to <data dir>/rank<r>.npz.
"""

import os
import sys

import numpy as np
import torch

from packnet_sfm_tpu_torch.egomotion.posegraph import PoseGraphConfig, optimize_pose_graph_sharded
from packnet_sfm_tpu_torch.parallel import mesh


def main(data_dir):
    mesh.init_distributed(device="cpu")
    g = np.load(os.path.join(data_dir, "graph.npz"))
    cfg = PoseGraphConfig(num_iterations=int(g["num_iterations"]),
                          optimize_scales=bool(g["optimize_scales"]))
    edges = {k: torch.from_numpy(g[k]) for k in ("i", "j", "Z", "w")}
    T, scales, cost = optimize_pose_graph_sharded(torch.from_numpy(g["T_init"]), edges, cfg)
    np.savez(os.path.join(data_dir, f"rank{mesh.process_index()}.npz"), T=T.numpy(),
             scales=scales.numpy(), cost=cost.numpy(), world=mesh.process_count())
    mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
