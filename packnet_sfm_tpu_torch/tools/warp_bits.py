"""The warp kernels of this checkout (``csrc/warp.cu``) against another
build of an earlier ``warp.cu`` whose ``warp_bwd`` took a ``d_image``
argument and summed d image with float atomics, bit for bit and in time, on
the card::

    git show <commit>:packnet_sfm_tpu_torch/csrc/warp.cu > build/other_warp.cu
    python -m packnet_sfm_tpu_torch.tools.warp_bits build/other_warp.cu

The other source is built with the same ``nvcc`` flags into the same build
directory. On seeded inputs at each case of ``CASES`` (coordinates that
leave the image, both paddings) and at the flagship loss's four scales:

- ``warp_fwd``, ``warp_bwd`` (d coords) and ``warp_jvp`` of both builds, and
  their bfloat16-image variants, must have the same bits;
- ``warp_bwd_image`` (float32 and bfloat16) is held to the plain version
  (autograd of ``grid_sample_plain``) within ``TOL`` of the largest
  magnitude, the bfloat16 one must be the float32 one rounded once, three
  calls must give the same bits, and it runs under
  ``torch.use_deterministic_algorithms(True)``; the other build's atomic
  d image is compared with it too (it may differ in the last bits);
- device times (CUDA events over 20 calls, the median of 5 rounds): the
  other build's atomic d image (its ``warp_bwd`` with a zeroed d image, the
  zeroing included) and ``warp_bwd_image`` in turns (other, this, other,
  this), and ``warp_bwd_image_bf16``; d coords alone, the other build's
  ``warp_bwd`` (a null d image) and this one's, for both image types, in
  turns too.

Prints one JSON line with the card's name and power limit, and exits 1
where any check fails.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

TOL = 1e-4
# (b, h, w, c, ho, wo, padding): output grids smaller and larger than the
# image, C = 3, 1 (the compiled counts) and 4 (the loop)
CASES = ((1, 48, 160, 3, 37, 75, "zeros"), (8, 48, 160, 1, 48, 160, "border"),
         (3, 33, 71, 4, 37, 75, "border"), (2, 6, 10, 3, 48, 160, "zeros"),
         (2, 5, 7, 3, 64, 96, "border"))
FLAGSHIP = ((8, 192, 640), (8, 96, 320), (8, 48, 160), (8, 24, 80))
_OTHER_SIGNATURES = {"warp_fwd": 3 + 7, "warp_bwd": 5 + 7, "warp_jvp": 4 + 7,
                     "warp_fwd_bf16": 3 + 7, "warp_bwd_bf16": 4 + 7}


def _build(source: Path) -> ctypes.CDLL:
    from packnet_sfm_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / f"libother_{source.stem}.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, n in _OTHER_SIGNATURES.items():
        # pointers first, then the seven ints, then the stream
        getattr(lib, fn).argtypes = ([ctypes.c_void_p] * (n - 7) + [ctypes.c_int] * 7
                                     + [ctypes.c_void_p])
        getattr(lib, fn).restype = ctypes.c_int
    return lib


_blocker = []


def _time_ms(fn, reps=20, rounds=5):
    """As chip_smoke.py's time_ms: a large matrix product keeps the card busy
    while the host enqueues the calls, so that the events time the device."""
    import torch

    if not _blocker:
        _blocker.append(torch.empty((8192, 8192), device="cuda").normal_())
    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.mm(_blocker[0], _blocker[0])
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _inputs(gen, b, h, w, c, ho, wo, device, spread=1.3, smooth=False):
    import torch

    image = torch.rand((b, h, w, c), generator=gen)
    if smooth:
        ys = torch.linspace(-1, 1, ho)[None, :, None].expand(b, ho, wo)
        xs = torch.linspace(-1, 1, wo)[None, None, :].expand(b, ho, wo)
        shift = (torch.rand((b, 1, 1, 2), generator=gen) - 0.5) * 0.1
        coords = torch.stack([xs, ys], dim=-1) + shift
    else:
        coords = (torch.rand((b, ho, wo, 2), generator=gen) * 2 - 1) * spread
    grad = torch.randn((b, ho, wo, c), generator=gen)
    tangent = torch.randn((b, ho, wo, 2), generator=gen)
    return [t.contiguous().to(device) for t in (image, coords, grad, tangent)]


def _other_outputs(lib, image, coords, grad, tangent, pad):
    """warp_fwd, d coords, d image (atomic), warp_jvp and the bfloat16
    variants' forward and d coords, of the other build."""
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda

    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    dims = (b, h, w, c, ho, wo, pad, _cuda.stream(image))
    out, jvp = (torch.empty((b, ho, wo, c), device=image.device) for _ in range(2))
    d_coords, d_coords16 = torch.empty_like(coords), torch.empty_like(coords)
    d_image = torch.zeros_like(image)
    out16 = torch.empty_like(out)
    img16 = image.bfloat16()
    errs = [lib.warp_fwd(image.data_ptr(), coords.data_ptr(), out.data_ptr(), *dims),
            lib.warp_bwd(image.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                         d_coords.data_ptr(), d_image.data_ptr(), *dims),
            lib.warp_jvp(image.data_ptr(), coords.data_ptr(), tangent.data_ptr(),
                         jvp.data_ptr(), *dims),
            lib.warp_fwd_bf16(img16.data_ptr(), coords.data_ptr(), out16.data_ptr(), *dims),
            lib.warp_bwd_bf16(img16.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                              d_coords16.data_ptr(), *dims)]
    torch.cuda.synchronize()
    if any(errs):
        raise RuntimeError(f"the other build's launch failed: {errs}")
    # d coords alone (a null d image), as this build's warp_bwd computes it
    d_coords_only = torch.empty_like(coords)
    if lib.warp_bwd(image.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                    d_coords_only.data_ptr(), None, *dims):
        raise RuntimeError("the other build's warp_bwd failed")
    torch.cuda.synchronize()
    return dict(fwd=out, bwd=d_coords_only, bwd_with_image=d_coords, jvp=jvp,
                fwd_bf16=out16, bwd_bf16=d_coords16), d_image


def _this_outputs(image, coords, grad, tangent, pad):
    import torch

    from packnet_sfm_tpu_torch.ops import warp

    mode = ("zeros", "border")[pad]
    img16 = image.bfloat16()
    out = dict(fwd=warp.warp_fwd_cuda(image, coords, mode),
               bwd=warp.warp_bwd_cuda(image, coords, grad, mode)[1],
               jvp=warp.warp_jvp_cuda(image, coords, tangent, mode),
               fwd_bf16=warp.warp_fwd_cuda(img16, coords, mode),
               bwd_bf16=warp.warp_bwd_cuda(img16, coords, grad, mode)[1])
    out["bwd_with_image"] = out["bwd"]
    torch.cuda.synchronize()
    return out


def _image_grad_checks(image, coords, grad, pad):
    """warp_bwd_image in both dtypes against the plain version, its bits over
    three calls and under deterministic algorithms. Returns (record, d image
    float32)."""
    import torch

    from packnet_sfm_tpu_torch.ops import warp

    mode = ("zeros", "border")[pad]
    hw = tuple(image.shape[1:3])
    ip = image.clone().requires_grad_()
    (warp.grid_sample_plain(ip, coords, mode) * grad).sum().backward()
    want = ip.grad
    runs = {dt: [warp.warp_bwd_image_cuda(coords, grad, hw, dt, mode) for _ in range(3)]
            for dt in (torch.float32, torch.bfloat16)}
    torch.use_deterministic_algorithms(True)
    try:
        for dt in runs:
            runs[dt].append(warp.warp_bwd_image_cuda(coords, grad, hw, dt, mode))
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    d32, d16 = runs[torch.float32][0], runs[torch.bfloat16][0]
    largest = want.abs().max().item()
    rel = (d32 - want).abs().max().item() / largest
    # a bfloat16 spacing of each element of the plain version
    spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -120))) - 7)
    rel16 = ((d16.float() - want).abs() - spacing).clamp(min=0).max().item() / largest
    same = all(torch.equal(r, rs[0]) for rs in runs.values() for r in rs)
    rounded = torch.equal(d16, d32.bfloat16())
    ok = (rel <= TOL and rel16 <= TOL and same and rounded
          and bool(torch.isfinite(d32).all()))
    return dict(rel_err=rel, rel_err_bf16_beyond_its_spacing=rel16, bits_equal_over_calls=same,
                bf16_is_float32_rounded=rounded, ok=ok), d32


def main(argv=None) -> int:
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda, warp

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = _build(Path(argv[0]))
    device = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    cases, ok = [], True
    collapsed = (1, 48, 160, 3, 48, 160, "border")
    for b, h, w, c, ho, wo, mode in CASES + (collapsed,) + tuple(
            (b, h, w, 3, h, w, "zeros") for b, h, w in FLAGSHIP):
        pad = warp.PADDING_MODES[mode]
        image, coords, grad, tangent = _inputs(gen, b, h, w, c, ho, wo, device,
                                               smooth=(b, h, w) in FLAGSHIP)
        if (b, h, w, c, ho, wo, mode) == collapsed:
            # 2000 samples clamped onto the bottom-right corner, the rest random
            coords.view(-1, 2)[:2000] = torch.tensor([3.0, 2.5], device=device)
        theirs, their_d_image = _other_outputs(other, image, coords, grad, tangent, pad)
        ours = _this_outputs(image, coords, grad, tangent, pad)
        equal = {k: bool(torch.equal(ours[k], theirs[k])) for k in ours}
        record, d32 = _image_grad_checks(image, coords, grad, pad)
        record["vs_atomic_rel"] = ((d32 - their_d_image).abs().max().item()
                                   / their_d_image.abs().max().item())
        ok &= all(equal.values()) and record["ok"]
        cases.append(dict(case=[b, h, w, c, ho, wo, mode], equal=equal, **record))
        print(json.dumps(cases[-1]), file=sys.stderr)

    times = []
    for b, h, w in FLAGSHIP:
        image, coords, grad, _ = _inputs(gen, b, h, w, 3, h, w, device, smooth=True)
        d_image, d_coords = torch.zeros_like(image), torch.empty_like(coords)

        def atomic():
            d_image.zero_()
            other.warp_bwd(image.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                           d_coords.data_ptr(), d_image.data_ptr(), b, h, w, 3, h, w, 0,
                           _cuda.stream(image))

        def this():
            warp.warp_bwd_image_cuda(coords, grad, (h, w))

        def this_bf16():
            warp.warp_bwd_image_cuda(coords, grad, (h, w), torch.bfloat16)

        img16 = image.bfloat16()

        def coords_only(lib, im, name):
            def launch():
                getattr(lib, name)(im.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                                   d_coords.data_ptr(), *([None] if lib is other and
                                                         name == "warp_bwd" else []),
                                   b, h, w, 3, h, w, 0, _cuda.stream(image))
            return launch

        ours = _cuda.load("warp")
        turns = [_time_ms(fn) for fn in (atomic, this, atomic, this)]
        times.append(dict(shape=[b, h, w, 3], atomic_this_atomic_this_ms=turns,
                          this_bf16_ms=_time_ms(this_bf16),
                          **{f"d_coords_{name}_other_this_other_this_ms": [
                              _time_ms(coords_only(lib, im, name))
                              for lib in (other, ours, other, ours)]
                             for name, im in (("warp_bwd", image), ("warp_bwd_bf16", img16))}))
        print(json.dumps(times[-1]), file=sys.stderr)
    print(json.dumps(dict(device=gpu, ok=ok, cases=cases, times=times)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
