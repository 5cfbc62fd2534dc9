"""The metric arithmetic on synthetic readings: rates as all work over all
time, the idle share as the union of device intervals, mfu from counted
FLOPs, the warp's roofline share from its bytes, the breakdown's names."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness, yardstick
from portbench.harness import PACKAGE, Registry, Run
from portbench.rooflines import warp
from portbench.trace import Trace, union_length

REG = Registry(PACKAGE.parent / "BENCHMARK.json")


class FakeCell:
    min_steps = 1

    def __init__(self, images=4, flops=1e12, launches=()):
        self._images, self._flops, self._launches = images, flops, list(launches)
        self.calls = []

    def images_per_step(self):
        return self._images

    def flops_per_step(self):
        return self._flops

    def warp_launches(self):
        return self._launches

    def step(self, i):
        self.calls.append(i)
        time.sleep(0.01)


def read(name, run, trace):
    return REG.code("metrics", name).read(run, trace)


def test_window_rate_is_all_work_over_all_time():
    import torch

    cell = FakeCell(images=4)
    steps, window_s, host_s = harness.window(cell, 0.1, 7, torch.device("cpu"))
    assert cell.calls == list(range(7, 7 + steps))
    assert window_s >= 0.1 and steps >= 5 and host_s <= window_s
    run = Run(cell, steps, window_s, host_s, 1e15)
    assert run.images == 4 * steps
    assert run.host_ms_per_step == pytest.approx(host_s / steps * 1e3)


def test_union_and_idle_share():
    length, merged = union_length([(0, 10), (5, 12), (20, 30), (29, 31), (40, 41)])
    assert length == 12 + 11 + 1 and merged == [[0, 12], [20, 31], [40, 41]]
    tr = Trace.from_records(2, 100e-6, [("k", 0, 10), ("k", 5, 12), ("k", 20, 31), ("k", 40, 41)])
    assert tr.busy_s() == pytest.approx(24e-6)
    # 12 us busy a traced step; the measured window ran 10 steps in 200 us
    run = Run(FakeCell(), steps=10, window_s=200e-6, host_s=1e-4, peak_flops=1e15)
    assert read("device_idle_pct.train", run, tr) == pytest.approx(40.0)
    assert read("device_idle_pct.eval", run, tr) == pytest.approx(40.0)


def test_mfu_from_counted_flops():
    cell = FakeCell(flops=2.0e12)
    run = Run(cell, steps=50, window_s=10.0, host_s=1.0, peak_flops=989e12)
    want = 100 * 2.0e12 * 50 / 10.0 / 989e12
    assert read("mfu.train", run, None) == pytest.approx(want)
    assert read("mfu.eval", run, None) == pytest.approx(want)


def test_warp_bytes_and_roofline_share():
    # float32 image, C = 3: 32 B a pixel forward, 40 backward; bfloat16 26 and 34
    assert warp.fwd_bytes(1, 3, 4) == 32 and warp.bwd_bytes(1, 3, 4) == 40
    assert warp.fwd_bytes(1, 3, 2) == 26 and warp.bwd_bytes(1, 3, 2) == 34
    launches = warp.step_launches(4, 192, 640, 2, 4, 2)
    assert [k for k, _ in launches] == ["warp_fwd", "warp_bwd"] * 4
    full = 2 * 4 * 192 * 640
    assert launches[0][1] == pytest.approx(full * 26 / yardstick.HBM_BYTES_PER_S)
    assert launches[-1][1] == yardstick.LAUNCH_FLOOR_S or launches[-1][1] > yardstick.LAUNCH_FLOOR_S
    bound = sum(s for _, s in launches)
    steps = 3
    ops = []
    t = 0.0
    for _ in range(steps):
        for k, s in launches:       # each kernel at twice its bound
            name = "void warp_fwd_kernel<bf16>" if k == "warp_fwd" else "void warp_bwd_kernel<bf16>"
            ops.append((name, t, t + 2 * s * 1e6))
            t += 3 * s * 1e6
    tr = Trace.from_records(steps, 1.0, ops + [("gemm", t, t + 5)])
    run = Run(FakeCell(launches=launches), 10, 1.0, 0.1, 1e15)
    assert read("warp_roofline_pct.host_paced", run, tr) == pytest.approx(50.0)
    assert bound > 0
    # launches that are not whole steps' worth, or none: nothing to read
    short = Trace.from_records(steps, 1.0, ops[:-1])
    assert read("warp_roofline_pct.host_paced", run, short) is None
    assert read("warp_roofline_pct.host_paced", Run(FakeCell(), 10, 1.0, 0.1, 1e15), tr) is None


def test_group_and_region_readers():
    tr = Trace.from_records(4, 1.0, [], groups={"conv2d": 8000.0, "conv3d": 4000.0},
                            regions={"photometric_loss": 400.0, "supervised_loss": 400.0,
                                     "optimizer": 1200.0, "depth_net": 2000.0},
                            host_ranges={"depth_metrics": 6000.0})
    assert read("conv2d_device_ms.train", None, tr) == pytest.approx(2.0)
    assert read("conv3d_device_ms.train", None, tr) == pytest.approx(1.0)
    assert read("loss_device_ms.train", None, tr) == pytest.approx(0.2)
    assert read("optimizer_device_ms.train", None, tr) == pytest.approx(0.3)
    assert read("depth_net_device_ms.eval", None, tr) == pytest.approx(0.5)
    assert read("depth_metrics_host_ms.eval", None, tr) == pytest.approx(1.5)
    empty = Trace.from_records(4, 1.0, [])
    assert read("conv3d_device_ms.train", None, empty) is None


def test_conv_groups_by_operator_rank():
    assert yardstick.group_of("sm90_xmma_fprop_implicit_gemm", 5) == "conv3d"
    assert yardstick.group_of("sm90_xmma_fprop_implicit_gemm", 4) == "conv2d"
    assert yardstick.group_of("vectorized_elementwise_kernel", 4) == "elementwise"
    assert yardstick.group_of("multi_tensor_apply_kernel", None) == "optimizer"
    assert yardstick.group_of("something_new", None) == "other"


def test_breakdown_names_gaps_by_the_host():
    ops = [("a", 0, 10), ("b", 30, 40), ("a", 41, 50), ("c", 100, 101)]
    host = [("portbench.step", 0, 200, 0), ("depth_net", 5, 60, 1),
            ("aten::conv2d", 12, 20, 2), ("aten::copy_", 60, 99, 1)]
    tr = Trace.from_records(1, 200e-6, ops, host_ops=host)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["a", pytest.approx(19e-6)]
    assert b["idle_gaps"][0] == ["portbench.step/aten::copy_", pytest.approx(50e-6)]
    assert b["idle_gaps"][1] == ["depth_net", pytest.approx(20e-6)]
    json.dumps(b)


def test_norm_gaps():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert yardstick.norm_gap(ref, ref) == 0.0
    assert yardstick.norm_gap({"a": 1.1, "b": 2.0, "c": 1e-9}, ref) == pytest.approx(0.1)
    # a leaf whose norm is far below the median is measured against the median
    assert yardstick.norm_gap({"a": 1.0, "b": 2.0, "c": 0.1}, ref) == pytest.approx(0.1)
    assert yardstick.norm_gap({"a": 1.0}, ref) == float("inf")
    assert yardstick.moved_leaves({"a": 1.0, "b": 2.0, "c": 1e-9}) == {"a", "b"}


@pytest.mark.parametrize("base", ["host_ms_per_step", "conv2d_device_ms", "conv3d_device_ms",
                                  "loss_device_ms", "optimizer_device_ms", "mfu",
                                  "device_idle_pct"])
def test_host_paced_readers_read_as_the_train_ones(base):
    tr = Trace.from_records(2, 1.0, [("k", 0, 1e5)], groups={"conv2d": 8000.0, "conv3d": 4000.0},
                            regions={"photometric_loss": 400.0, "optimizer": 1200.0})
    run = Run(FakeCell(), 10, 2.0, 0.5, 1e15)
    want = read(f"{base}.train", run, tr)
    assert want is not None and read(f"{base}.host_paced", run, tr) == pytest.approx(want)


@pytest.mark.parametrize("base", ["host_ms_per_step", "device_idle_pct"])
def test_unbounded_readers_read_as_the_train_ones(base):
    tr = Trace.from_records(2, 1.0, [("k", 0, 1e5)])
    run = Run(FakeCell(), 10, 2.0, 0.5, 1e15)
    want = read(f"{base}.train", run, tr)
    assert want is not None and read(f"{base}.unbounded", run, tr) == pytest.approx(want)


def test_the_unbounded_rate_is_all_work_over_all_time():
    run = Run(FakeCell(images=4), 10, 2.5, 0.5, 1e15)
    assert read("host_paced_train_images_per_s.unbounded", run, None) == pytest.approx(16.0)
