"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size, many seeds in one process:

    python3 -m portbench.control --workload <name> --seeds 1 2 3 ... [--control 3]
        [--faults [FAULT ...]] [--fault-seeds 3]

For each seed it builds the cell as a run does and takes the program's
readings (the train kinds' first steps; the eval kind's steps twice over
its pool, a short window at the cell's own load), then the reference's in
float64, and prints the compared numbers. ``--control N`` also, on the
first N seeds, puts the reference in the program's place, computed in
float32 and the precision below the cell's (``control_precision``), and
prints its numbers against the float64 reference. ``--faults`` runs the
program broken in each way named, or in each way the cell can be
(``FAULTS``), on the first ``--fault-seeds`` seeds, and prints those
numbers. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from portbench.harness import Registry

# a step that leaves the state unchanged; half of the batch left out (the
# mean over the rest); an answer altered where it is produced
FAULTS = {"train": ("state_unchanged", "half_batch"),
          "eval": ("half_batch", "answer_altered")}


def rounding(name: str):
    """A cast that rounds a tensor to the lower precision ``name`` and back
    to float32, its gradient likewise: 'bfloat16', or 'fp8' (E4M3 forward,
    E5M2 backward, each scaled per tensor to its format's largest value)."""
    if name == "bfloat16":
        def fwd(t):
            return t.to(torch.bfloat16).to(t.dtype)
        bwd = fwd
    elif name == "fp8":
        def scaled(t, dtype, top):
            s = t.detach().abs().amax().clamp(min=1e-30) / top
            return (t / s).to(dtype).to(t.dtype) * s

        def fwd(t):
            return scaled(t, torch.float8_e4m3fn, 448.0)

        def bwd(t):
            return scaled(t, torch.float8_e5m2, 57344.0)
    else:
        raise ValueError(f"no rounding {name}")

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fwd(x)

        @staticmethod
        def backward(ctx, g):
            return bwd(g)

    return Round.apply


def control_precision(spec: dict) -> str:
    """The precision below a cell's (its ``precision`` and ``tf32`` flags):
    'fp8' under bfloat16, 'tf32' under float32 with TF32 off, 'bfloat16'
    under float32 with TF32 on."""
    if spec["precision"] != "float32":
        return "fp8"
    return "bfloat16" if any(spec["tf32"].values()) else "tf32"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def build(registry: Registry, workload: str, seed: int, device, fault=None):
    """The cell's program side, set up as a run sets it up, and (for eval)
    stepped once over its pool."""
    w = registry.workload(workload)
    traffic = registry.data("traffic", w["traffic"])
    spec = registry.data("cells", workload)
    torch.backends.cudnn.allow_tf32 = spec["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]["matmul"]
    kind = registry.code("kinds", traffic["kind"])
    cell = kind.build(registry.data("configs", w["config"]), traffic, spec, seed, device,
                      registry.code("traffic", traffic["kind"]).make_pool, fault)
    if traffic["kind"] == "eval":        # a short window at the cell's own load
        for i in range(2 * len(cell.pool)):
            cell.step(i)
    return cell, spec, traffic["kind"]


def readings(registry: Registry, workload: str, seed: int, device, control: bool,
             fault=None) -> dict:
    t0 = time.perf_counter()
    cell, spec, kind = build(registry, workload, seed, device, fault)
    got = cell.readings()
    cell.free()
    t1 = time.perf_counter()
    ref = cell.reference()
    sync(device)
    out = {"workload": workload, "seed": seed, "fault": fault,
           "program": cell.compare(got, ref),
           "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}
    if control:
        name = control_precision(spec)
        low = (cell.reference(torch.float32, tf32=True) if name == "tf32"
               else cell.reference(torch.float32, cast=rounding(name)))
        out["control"] = {"precision": name, **cell.compare(low, ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0, metavar="N",
                    help="also the control, on the first N seeds")
    ap.add_argument("--faults", nargs="*", metavar="FAULT",
                    help="also the program broken in each of these ways (none named: "
                         "every way the cell's kind can be)")
    ap.add_argument("--fault-seeds", type=int, default=3, metavar="N",
                    help="each fault on the first N seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.control needs a CUDA device")
    registry = Registry(Path.cwd() / "BENCHMARK.json")
    device = torch.device("cuda", 0)
    kind = registry.data("traffic", registry.workload(args.workload)["traffic"])["kind"]
    for seed in args.seeds:
        control = seed in args.seeds[:args.control]
        print(json.dumps(readings(registry, args.workload, seed, device, control)),
              flush=True)
        torch.cuda.empty_cache()
    if args.faults is not None:
        for fault in args.faults or FAULTS[kind]:
            if fault not in FAULTS[kind]:
                raise SystemExit(f"no fault {fault} in a {kind} cell: {', '.join(FAULTS[kind])}")
            for seed in args.seeds[:args.fault_seeds]:
                print(json.dumps(readings(registry, args.workload, seed, device, False, fault)),
                      flush=True)
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
