"""The whole-image soft-argmax kernels of this checkout (K6f/K6b,
``csrc/softargmax.cu``'s ``softargmax_fwd``/``softargmax_bwd``) against
another build of that source, bit for bit and in time, on the card::

    git show <commit>:packnet_sfm_tpu_torch/csrc/softargmax.cu > build/other_softargmax.cu
    python -m packnet_sfm_tpu_torch.tools.softargmax_bits build/other_softargmax.cu

The other source is built with the same ``nvcc`` flags into the same
build directory. On seeded unit vectors at each shape of ``CASES`` both
builds run the forward and then the backward on the forward's statistics;
every output (ex, ey, m, s, d direction, d rays) must have the same bits.
The forward's device time (CUDA events over 20 launches, the median of 5
rounds) is taken in turns: other, this, other, this. Prints one JSON line
with the card's name, and exits 1 where any output differs.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

PATCH = 20
# (batch, height, width, temperature): the NRS grid at the path's and a
# dense temperature, a wide and a small image, the omnicam image whole
CASES = ((1, 192, 192, 9.5e-5), (2, 192, 192, 0.05), (1, 96, 320, 1e-4), (2, 41, 50, 0.05),
         (1, 384, 384, 9.5e-5))


def _build(source: Path) -> Path:
    from packnet_sfm_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / f"libother_{source.stem}.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(source)], check=True)
    return out


def _typed(lib):
    from packnet_sfm_tpu_torch.ops import _cuda

    for fn in ("softargmax_fwd", "softargmax_bwd"):
        getattr(lib, fn).argtypes = _cuda.SIGNATURES["softargmax"][fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _run(lib, d, r, gex, gey, temperature):
    """ex, ey, m, s, d direction, d rays of one build."""
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda

    b, _, h, w = d.shape
    ex, ey, m, s = (torch.empty((b, h, w), device=d.device) for _ in range(4))
    if lib.softargmax_fwd(d.data_ptr(), r.data_ptr(), ex.data_ptr(), ey.data_ptr(),
                          m.data_ptr(), s.data_ptr(), b, h, w, PATCH, temperature,
                          _cuda.stream(d)):
        raise RuntimeError("softargmax_fwd failed")
    dd, dr = torch.empty_like(d), torch.empty_like(r)
    if lib.softargmax_bwd(d.data_ptr(), r.data_ptr(), ex.data_ptr(), ey.data_ptr(),
                          m.data_ptr(), s.data_ptr(), gex.data_ptr(), gey.data_ptr(),
                          dd.data_ptr(), dr.data_ptr(), b, h, w, PATCH, temperature,
                          _cuda.stream(d)):
        raise RuntimeError("softargmax_bwd failed")
    torch.cuda.synchronize()
    return ex, ey, m, s, dd, dr


def _forward_ms(lib, d, r, temperature, reps=20, rounds=5):
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda

    b, _, h, w = d.shape
    out = [torch.empty((b, h, w), device=d.device) for _ in range(4)]
    ptrs = [t.data_ptr() for t in out]

    def launch():
        lib.softargmax_fwd(d.data_ptr(), r.data_ptr(), *ptrs, b, h, w, PATCH, temperature,
                           _cuda.stream(d))

    launch()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main(argv=None) -> int:
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = _typed(ctypes.CDLL(str(_build(Path(argv[0])))))
    this = _cuda.load("softargmax")
    device = torch.device("cuda")
    cases, same = [], True
    for b, h, w, t in CASES:
        gen = torch.Generator().manual_seed(h + w)
        d, r = (torch.randn((b, 3, h, w), generator=gen) for _ in range(2))
        d, r = ((v / v.norm(dim=1, keepdim=True)).to(device) for v in (d, r))
        gex, gey = (torch.randn((b, h, w), generator=gen).to(device) for _ in range(2))
        equal = [bool(torch.equal(x, y)) for x, y in zip(_run(other, d, r, gex, gey, t),
                                                          _run(this, d, r, gex, gey, t))]
        same &= all(equal)
        ms = [_forward_ms(lib, d, r, t) for lib in (other, this, other, this)]
        cases.append(dict(shape=[b, 3, h, w], temperature=t, equal=equal,
                          fwd_ms_other_this_other_this=ms))
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), bit_equal=same, cases=cases)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
