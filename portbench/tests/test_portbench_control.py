"""The control of ``correct``: the reference put in the program's place and
computed in the precision below the configuration's fails the check.

On the CPU at a tiny size (float32 cells, so a bfloat16 control), and, with
the ``cuda`` marker, on the card at each cell's own size and limits:

    python -m pytest portbench/tests -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.harness import PACKAGE, Registry
from portbench.tests import tiny


@pytest.mark.parametrize("workload", ["tiny_train", "tiny_eval"])
def test_control_fails_where_the_program_passes(tmp_path, workload):
    reg = tiny.write(tmp_path)
    limits = reg.data("cells", workload)["limits"]
    out = control.readings(reg, workload, 2 ** 31 + 29, torch.device("cpu"), True)
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


def test_rounding_rounds_both_ways():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    for name, step in (("bfloat16", 2 ** -8), ("fp8", 2 ** -3)):
        y = control.rounding(name)(x)
        err = ((y - x).abs() / x.abs().clamp(min=1e-3)).max().item()
        assert 0 < err <= step * 1.01
        g = torch.linspace(0.5, 1.5, 1001) + 2 ** -12
        y.backward(g)
        assert not torch.equal(x.grad, g)
        assert ((x.grad - g).abs() / g).max().item() <= 4 * step
        x.grad = None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti_train_bf16_b4", "san_kitti_train_f32_b1",
                                      "kitti_eval_f32_b4", "kitti_train_bf16_b16"])
def test_control_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    reg = Registry(PACKAGE.parent / "BENCHMARK.json")
    limits = reg.data("cells", workload)["limits"]
    out = control.readings(reg, workload, 2 ** 31 + 41, torch.device("cuda", 0), True)
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


@pytest.mark.parametrize("precision, tf32, want", [
    ("bfloat16", {"cudnn": True, "matmul": False}, "fp8"),
    ("float32", {"cudnn": False, "matmul": False}, "tf32"),
    ("float32", {"cudnn": True, "matmul": False}, "bfloat16")])
def test_control_precision_follows_the_cell(precision, tf32, want):
    assert control.control_precision({"precision": precision, "tf32": tf32}) == want


def test_eval_share_gap_counts_pixels():
    from portbench.kinds.eval import EvalCell
    from portbench.reference.steps import EVAL_MODES

    rows = torch.tensor([[0.1, 0.2, 3.0, 0.2, 0.5, 0.8, 0.9]] * 2, dtype=torch.float64)
    want = {0: {**{m: rows for m in EVAL_MODES}, "inv_depth": torch.ones(2, 4, 4, 1),
                "valid_px": torch.tensor([1000.0, 4000.0])}}
    got = {0: {m: rows.clone() for m in (*EVAL_MODES, "inv_depth")}}
    got[0]["inv_depth"] = torch.ones(2, 4, 4, 1)
    assert EvalCell.compare(got, want) == {"metric_gap": 0.0, "share_gap_px": 0.0, "inv_gap": 0.0}
    got[0]["depth_pp"] = rows.clone()
    got[0]["depth_pp"][1, 5] += 3 / 4000      # three pixels of the second sample
    assert EvalCell.compare(got, want)["share_gap_px"] == pytest.approx(3.0)
    got[0]["depth"] = rows[:1]                 # half the batch
    assert EvalCell.compare(got, want)["share_gap_px"] == float("inf")
