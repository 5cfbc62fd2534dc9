"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, the program
(``packnet_sfm_tpu_torch``) and this package. Needs as many CUDA devices as
the cell asks for, and exits with code 5 and no result where there are
fewer. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error repeat the checks. Exits with code 6 and
no result if the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "packnet_sfm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: 'packnet_sfm_tpu_torch' is not 'packnet_sfm_tpu')."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import Registry, run_cell

    registry = Registry(Path.cwd() / "BENCHMARK.json")
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 5
    device = torch.device("cuda", 0)
    out = run_cell(registry, args.workload, args.seed, args.seconds, bool(args.trace), device,
                   clock_start=t0)

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 6
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["trace_window_s"]
    result = {"correct": out["correct"], "attempted": out["steps"], "failed": 0,
              "metrics": out["metrics"], "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
