"""What the train step's CUDA graph (``engine/train.make_train_step``) rests
on, on the CPU:

- the constants that the step builds on its device with no copy from the
  host (``ops/fold_conv.ring_indices``, ``ops/image._source_positions``'
  scalars, ``geometry/pose._bottom_row``, ``geometry/se3.se3_exp``'s bottom
  row) equal the host-built tensors they replace, bit for bit, in float32,
  bfloat16 and float64;
- the flip selected by a device flag (``models/sfm._depth_with_flip``'s
  ``flip_flag``) equals the eager branch: the inverse depths and the
  gradients of the network's weights and of its inputs, for a network of
  the image alone and one that also takes 'input_depth';
- the rule of where the graph engages (``engine/train.captures_graph``):
  only a CUDA device, no process group, no grid, one microbatch, a kind
  whose loss trains and does not read ``progress``, a capturable Adam;
- ``engine/factory.make_optimizer`` on the CPU builds the Adam it built
  before (float rates, not capturable), and a state loaded into the card's
  form is brought back to it (``_capturable_on``).

The graph itself needs a card: ``tests/test_torch_cuda.py``.
"""

import copy

import pytest
import torch
from torch import nn

from packnet_sfm_tpu_torch.core.config import KITTI, config_from_dict
from packnet_sfm_tpu_torch.engine import factory
from packnet_sfm_tpu_torch.engine.train import captures_graph
from packnet_sfm_tpu_torch.geometry import pose, se3
from packnet_sfm_tpu_torch.models import sfm
from packnet_sfm_tpu_torch.models.sfm import SfmModelDef
from packnet_sfm_tpu_torch.ops import fold_conv
from packnet_sfm_tpu_torch.ops.image import _source_positions

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16, torch.float64]


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_ring_indices_are_the_host_lists(m):
    near, far = fold_conv.ring_indices(m, torch.device("cpu"))
    want_near = torch.tensor([m - 1 - p for p in range(m)])
    want_far = torch.tensor([m + 1 + t for t in range(m)])
    assert near.dtype == want_near.dtype and torch.equal(near, want_near)
    assert far.dtype == want_far.dtype and torch.equal(far, want_far)


def _old_source_positions(size_in, size_out, dtype):
    if dtype == torch.float32 or size_out < 2:
        return torch.linspace(0.0, size_in - 1.0, size_out, dtype=dtype)
    div = size_out - 1
    iota = torch.arange(div, dtype=torch.float32).to(dtype)
    stop = torch.tensor(size_in - 1.0, dtype=dtype)
    return torch.cat([stop * (iota / torch.tensor(float(div), dtype=dtype)), stop[None]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size_in,size_out", [(640, 320), (383, 384), (192, 96), (1216, 608),
                                              (375, 1242), (24, 48), (7, 1)])
def test_source_positions_are_the_host_built_ones(size_in, size_out, dtype):
    got = _source_positions(size_in, size_out, dtype, torch.device("cpu"))
    want = _old_source_positions(size_in, size_out, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.dtype == want.dtype and torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pose_and_se3_bottom_rows_are_the_host_row(dtype):
    gen = torch.Generator().manual_seed(0)
    vec = (torch.randn(3, 2, 6, generator=gen) * 0.1).to(dtype)
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    for mat in (pose.pose_vec_to_mat(vec), se3.se3_exp(vec)):
        assert mat.dtype == dtype and mat.shape == (3, 2, 4, 4)
        assert torch.equal(mat[..., 3, :], row.expand(3, 2, 4))
        assert not mat[..., 3, :].signbit().any()
    top = torch.randn(5, 3, 4, generator=gen).to(dtype)
    assert torch.equal(pose._bottom_row(top), row.expand(5, 1, 4))


class _TinyDepth(nn.Module):
    """A depth network of four scales, NHWC in and out; with ``rgbd`` it
    also takes 'input_depth' and returns the rgb+d pass's inverse depths."""

    def __init__(self, rgbd: bool):
        super().__init__()
        self.rgbd = rgbd
        self.conv = nn.Conv2d(4 if rgbd else 3, 1, 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.randn(self.conv.weight.shape,
                                               generator=torch.Generator().manual_seed(1)))

    def forward(self, rgb, input_depth=None):
        x = rgb if input_depth is None else torch.cat([rgb, input_depth], dim=-1)
        y = torch.sigmoid(self.conv(x.permute(0, 3, 1, 2)))
        scales = [nn.functional.avg_pool2d(y, 2 ** i) if i else y for i in range(4)]
        inv = [s.permute(0, 2, 3, 1) for s in scales]
        if not self.rgbd:
            return inv
        return {"inv_depths": inv, "inv_depths_rgbd": [d * 0.5 for d in inv]}


def _inputs(rgbd: bool):
    gen = torch.Generator().manual_seed(2)
    batch = {"rgb": torch.rand(2, 8, 12, 3, generator=gen, requires_grad=True)}
    if rgbd:
        batch["input_depth"] = torch.rand(2, 8, 12, 1, generator=gen, requires_grad=True)
    return batch


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_the_flag_selected_flip_is_the_branch(monkeypatch, flip, rgbd):
    keys = ("rgb", "input_depth") if rgbd else ("rgb",)
    model = SfmModelDef(_TinyDepth(rgbd), None, kind="SelfSupModel", input_keys=keys)
    results = []
    for mode in ("branch", "flag"):
        batch = _inputs(rgbd)
        model.zero_grad(set_to_none=True)
        if mode == "branch":
            monkeypatch.setattr(sfm, "draw_flip", lambda m, g: flip)
            out = sfm._depth_with_flip(model, batch, None, True)
        else:
            monkeypatch.setattr(sfm, "draw_flip", lambda m, g: pytest.fail("drew a flip"))
            out = sfm._depth_with_flip(model, batch, None, True,
                                       flip_flag=torch.tensor(flip))
        outs = [d for key in ("inv_depths", "inv_depths_rgbd") for d in out.get(key, [])]
        # a loss that is not symmetric in W, so that a wrong flip shows
        ramp = torch.linspace(0.5, 2.0, 12)[None, None, :, None]
        loss = sum((d * ramp[..., :d.shape[2], :]).sum() * (i + 1) for i, d in enumerate(outs))
        loss.backward()
        results.append(([d.detach() for d in outs],
                        [p.grad.clone() for p in model.parameters()],
                        [batch[k].grad.clone() for k in keys]))
    (want_out, want_w, want_x), (got_out, got_w, got_x) = results
    for a, b in zip(got_out + got_w + got_x, want_out + want_w + want_x):
        assert a.shape == b.shape and torch.equal(a, b)


def _model(kind="SelfSupModel"):
    return SfmModelDef(_TinyDepth(False), None, kind=kind)


def _capturable_adam(model):
    return torch.optim.Adam([{"params": list(model.parameters()), "lr": torch.tensor(2e-4)}],
                            capturable=True)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("case,want", [
    ("one process on a card", True),
    ("the CPU", False),
    ("a process group", False),
    ("a band", False),
    ("grad_accum 2", False),
    ("NRS's kind", False),
    ("a kind without a loss", False),
    ("an Adam that is not capturable", False),
    ("a rate that is a float", False),
])
def test_the_graph_engages_by_what_the_step_observes(case, want):
    kind = {"NRS's kind": "GenericSelfSupModel",
            "a kind without a loss": "SfmModel"}.get(case, "SelfSupModel")
    model = _model(kind)
    optimizer = _capturable_adam(model)
    if case == "an Adam that is not capturable":
        optimizer.param_groups[0]["capturable"] = False
    if case == "a rate that is a float":
        optimizer.param_groups[0]["lr"] = 2e-4
    args = dict(device=torch.device("cpu") if case == "the CPU" else CUDA, model=model,
                optimizer=optimizer, grad_accum=2 if case == "grad_accum 2" else 1,
                mesh=object() if case == "a band" else None,
                distributed=case == "a process group")
    assert captures_graph(**args) is want


def _kitti(scheduler="StepLR"):
    raw = copy.deepcopy(KITTI)
    raw["model"]["depth_net"] = {"name": "PackNetSlim01", "version": "1A"}
    raw["model"]["scheduler"]["name"] = scheduler
    raw["model"]["scheduler"]["T_max"] = 3
    return config_from_dict(raw)


@pytest.mark.parametrize("scheduler", ["StepLR", "CosineAnnealingLR"])
def test_make_optimizer_on_the_cpu_builds_the_adam_it_built(scheduler):
    cfg = _kitti(scheduler)
    model = factory.setup_model(cfg.model, device="cpu", seed=0)
    optimizer, schedule = factory.make_optimizer(model, cfg.model.optimizer,
                                                 cfg.model.scheduler, 4)
    plain = torch.optim.Adam([
        {"params": list(model.depth_net.parameters()), "lr": cfg.model.optimizer.depth.lr,
         "weight_decay": cfg.model.optimizer.depth.get("weight_decay", 0.0)},
        {"params": list(model.pose_net.parameters()), "lr": cfg.model.optimizer.pose.lr,
         "weight_decay": cfg.model.optimizer.pose.get("weight_decay", 0.0)}])
    assert type(optimizer) is torch.optim.Adam and optimizer.defaults == plain.defaults
    assert not optimizer.defaults["capturable"]
    for group, want in zip(optimizer.param_groups, plain.param_groups):
        assert isinstance(group["lr"], float) and group["lr"] == want["lr"]
        assert {k: v for k, v in group.items() if k not in ("params", "initial_lr")} == \
            {k: v for k, v in want.items() if k != "params"}
    assert not optimizer._optimizer_load_state_dict_post_hooks
    base = [g["lr"] for g in optimizer.param_groups]
    for _ in range(9):
        optimizer.step()
        schedule.step()
    assert all(isinstance(g["lr"], float) for g in optimizer.param_groups)
    assert [g["lr"] for g in optimizer.param_groups] != base or scheduler == "StepLR"


def test_a_loaded_state_is_brought_back_to_the_cards_form():
    model = _model()
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()            # a CPU Adam's state: a float rate, CPU step counts
    factory._capturable_on(optimizer, torch.device("cpu"))
    (group,) = optimizer.param_groups
    assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
    assert group["lr"].dtype == torch.float32 and group["lr"].shape == ()
    assert group["lr"].item() == torch.tensor(3e-4).item()
    for state in optimizer.state.values():
        assert state["step"].dtype == torch.float32 and state["step"].item() == 1.0
