"""The reference against the program on the CPU at tiny sizes, for both
configurations' networks (PackNet01 + PoseNet, PackNet-SAN01): the same
weights from the benchmark's draw, the same batch from its traffic, the
same flip; the forward, the loss, the first gradient and three Adam steps.
(A test file may import both; the reference itself imports nothing of the
program.)"""

from __future__ import annotations

import pytest
import torch

from portbench import weights, yardstick
from portbench.kinds.train import TrainCell
from portbench.reference import steps as ref_steps
from portbench.tests import tiny
from portbench.traffic import train as train_traffic


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("depth_net,shape", [("PackNet01", (64, 96)), ("PackNetSAN01", (64, 96))])
def test_networks_agree(depth_net, shape):
    from packnet_sfm_tpu_torch.core.config import config_from_dict
    from packnet_sfm_tpu_torch.engine.factory import setup_model

    config = {"packnet_san_kitti" if depth_net == "PackNetSAN01" else "packnet01_kitti": None}
    name = next(iter(config))
    body = tiny.json.loads((tiny.PACKAGE / "configs" / f"{name}.json").read_text())
    cfg = config_from_dict(body["train"])
    model = setup_model(cfg.model, device="cpu", seed=0)
    weights.load(model, 11)
    nets = ref_steps.build(depth_net, model.pose_net is not None)
    weights.load(nets, 11)
    gen = torch.Generator().manual_seed(0)
    rgb = torch.rand(1, *shape, 3, generator=gen)
    depth = torch.rand(1, *shape, 1, generator=gen) * (torch.rand(1, *shape, 1, generator=gen) < 0.1)
    model.train(), nets.train()
    with torch.no_grad():
        if depth_net == "PackNetSAN01":
            a = model.depth_net(rgb, depth)
            b = nets["depth_net"](rgb, depth)
            pairs = list(zip(a["inv_depths_rgbd"] + a["inv_depths"], b["inv_depths_rgbd"] + b["inv_depths"]))
            pairs.append((a["depth_loss"], b["depth_loss"]))
        else:
            ctx = [torch.rand(1, *shape, 3, generator=gen) for _ in range(2)]
            pairs = list(zip(model.depth_net(rgb), nets["depth_net"](rgb)))
            pairs.append((model.pose_net(rgb, ctx), nets["pose_net"](rgb, ctx)))
    for p, r in pairs:
        assert p.shape == r.shape
        torch.testing.assert_close(p, r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("workload", ["tiny_train", "tiny_san"])
def test_three_steps_agree(registry, workload):
    """The program's first three train steps (loss, first gradient, change)
    against the reference's, float32 on the CPU."""
    w = registry.workload(workload)
    traffic = registry.data("traffic", w["traffic"])
    cell = TrainCell(registry.data("configs", w["config"]), traffic,
                     registry.data("cells", workload), 2 ** 31 + 5, torch.device("cpu"),
                     train_traffic.make_pool)
    got = cell.readings()
    cell.free()
    gaps = cell.compare(got, cell.reference())
    limits = tiny.LIMITS_TRAIN
    assert all(gaps[k] < limits[k] for k in limits), gaps
    assert yardstick.moved_leaves(cell.reference()[1])
