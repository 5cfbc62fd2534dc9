"""The warp kernels of this checkout (``csrc/warp.cu``) against another
build of an earlier ``warp.cu``, bit for bit and in time, on the card::

    mkdir -p build
    git show <commit>:packnet_sfm_tpu_torch/csrc/warp.cu > build/other_warp.cu
    python -m packnet_sfm_tpu_torch.tools.warp_bits build/other_warp.cu

The other source is built with the same ``nvcc`` flags into the same build
directory. Its image gradient is driven as its launchers say: a source that
exports ``warp_bwd_image_count`` takes the count, the caller's int32 scan
(``torch.cumsum``) and ``warp_bwd_image`` over a per-pixel index; one
without it takes this checkout's interface (fill and records of its own
``TILE_H``, ``TILE_W`` and ``BIN_RECORDS``, read from the source). On seeded
inputs at each case of ``CASES`` (coordinates that leave the image, both
paddings, tiles cut by the image's edge, a bin at and just over
``BIN_RECORDS``, a 1 x 1 image), smooth 2x and 4x zoom-ins, a collapsed
case (2000 samples clamped onto one corner), one with every tap off the
image, and the flagship loss's four scales in both paddings:

- ``warp_fwd``, ``warp_bwd`` (d coords), ``warp_jvp``, their bfloat16-image
  variants, and ``warp_bwd_image`` and ``warp_bwd_image_bf16`` of both
  builds must have the same bits;
- ``warp_bwd_image`` (float32 and bfloat16) is held to the plain version
  (autograd of ``grid_sample_plain``) within ``TOL`` of the largest
  magnitude, the bfloat16 one must be the float32 one rounded once, three
  calls must give the same bits, and it runs under
  ``torch.use_deterministic_algorithms(True)``;
- device times (CUDA events over 20 calls, the median of 5 rounds), in
  turns (other, this, other, this) at the four flagship scales: the image
  gradient in both dtypes ('zeros' padding) and in float32 with 'border'
  padding through each build's wrapper route (scratch allocation and the
  other build's scan included), and d coords alone (``warp_bwd``,
  ``warp_bwd_bf16``).

Prints one JSON line with the card's name and power limit, and exits 1
where any check fails.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

TOL = 1e-4
# (b, h, w, c, ho, wo, padding): output grids smaller and larger than the
# image, C = 3, 1 (the compiled counts) and 4 (the loop); 33 x 71 and 13 x 45
# cut the 8 x 32 tiles at both edges; an 8 x 32 image is one tile, and 64 x 128
# outputs are 256 warps on it (BIN_RECORDS), 64 x 130 are 260 (the walk)
CASES = ((1, 48, 160, 3, 37, 75, "zeros"), (8, 48, 160, 1, 48, 160, "border"),
         (3, 33, 71, 4, 37, 75, "border"), (2, 6, 10, 3, 48, 160, "zeros"),
         (2, 5, 7, 3, 64, 96, "border"), (2, 13, 45, 2, 20, 50, "zeros"),
         (1, 8, 32, 3, 64, 128, "zeros"), (1, 8, 32, 3, 64, 130, "border"),
         (2, 1, 1, 3, 9, 40, "zeros"))
# smooth zoom-ins: outputs 2x and 4x the image each way (bins of 48 and 160
# records, slots over several rounds, crowded cells)
ZOOM_IN = ((2, 96, 320, 3, 192, 640, "zeros"), (2, 48, 160, 3, 192, 640, "border"))
COLLAPSED = (1, 48, 160, 3, 48, 160, "border")
OUTSIDE = (2, 24, 80, 3, 24, 80, "zeros")       # every tap off the image
FLAGSHIP = ((8, 192, 640), (8, 96, 320), (8, 48, 160), (8, 24, 80))
_ARGS = {"warp_fwd": 3, "warp_bwd": 4, "warp_jvp": 4, "warp_fwd_bf16": 3, "warp_bwd_bf16": 4}


def _typed(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _build(source: Path):
    """The other build, and how its image gradient is driven: ("scan", None)
    or ("tiles", (tile_h, tile_w, bin_records))."""
    from packnet_sfm_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / f"libother_{source.stem}.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    for name, n_ptr in _ARGS.items():
        _typed(lib, name, n_ptr, 7)
    if hasattr(lib, "warp_bwd_image_count"):
        _typed(lib, "warp_bwd_image_count", 2, 6)
        for name in ("warp_bwd_image", "warp_bwd_image_bf16"):
            _typed(lib, name, 7, 7)
        return lib, ("scan", None)
    text = source.read_text()
    consts = tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                   for k in ("TILE_H", "TILE_W", "BIN_RECORDS"))
    for name in ("warp_bwd_image", "warp_bwd_image_bf16"):
        _typed(lib, name, 5, 7)
    return lib, ("tiles", consts)


def _other_image_grad(lib, route, coords, grad, hw, dtype, pad):
    """d image through the other build, as its wrapper drove it."""
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda

    kind, consts = route
    b, ho, wo, c = grad.shape
    h, w = hw
    dev = coords.device
    d_image = torch.empty((b, h, w, c), dtype=dtype, device=dev)
    name = "warp_bwd_image" + ("_bf16" if dtype == torch.bfloat16 else "")
    dims = (b, h, w, c, ho, wo, pad, _cuda.stream(coords))
    if kind == "scan":
        n_targets = b * h * w
        counts = torch.zeros(n_targets, dtype=torch.int32, device=dev)
        offsets = torch.zeros(n_targets + 1, dtype=torch.int32, device=dev)
        keys = torch.empty(4 * b * ho * wo, dtype=torch.int32, device=dev)
        lists = torch.empty(2 + 2 * n_targets, dtype=torch.int32, device=dev)
        err = lib.warp_bwd_image_count(coords.data_ptr(), counts.data_ptr(), b, h, w, ho, wo,
                                       pad, _cuda.stream(coords))
        torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
        counts.zero_()
        lists[:2].zero_()
        err = err or getattr(lib, name)(coords.data_ptr(), grad.data_ptr(), offsets.data_ptr(),
                                         counts.data_ptr(), keys.data_ptr(), lists.data_ptr(),
                                         d_image.data_ptr(), *dims)
    else:
        tile_h, tile_w, bin_records = consts
        n_tiles = b * -(-h // tile_h) * -(-w // tile_w)
        fill = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        records = torch.empty(2 * bin_records * n_tiles, dtype=torch.int32, device=dev)
        err = getattr(lib, name)(coords.data_ptr(), grad.data_ptr(), fill.data_ptr(),
                                 records.data_ptr(), d_image.data_ptr(), *dims)
    if err:
        raise RuntimeError(f"the other build's {name} failed: cudaError {err}")
    return d_image


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


def _other_outputs(lib, route, image, coords, grad, tangent, pad):
    """warp_fwd, d coords, warp_jvp, the bfloat16 variants' forward and d
    coords, and d image in both dtypes, of the other build."""
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda

    b, h, w, c = image.shape
    _, ho, wo, _ = coords.shape
    dims = (b, h, w, c, ho, wo, pad, _cuda.stream(image))
    out, jvp, out16 = (torch.empty((b, ho, wo, c), device=image.device) for _ in range(3))
    d_coords, d_coords16 = torch.empty_like(coords), torch.empty_like(coords)
    img16 = image.bfloat16()
    errs = [lib.warp_fwd(image.data_ptr(), coords.data_ptr(), out.data_ptr(), *dims),
            lib.warp_bwd(image.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                         d_coords.data_ptr(), *dims),
            lib.warp_jvp(image.data_ptr(), coords.data_ptr(), tangent.data_ptr(),
                         jvp.data_ptr(), *dims),
            lib.warp_fwd_bf16(img16.data_ptr(), coords.data_ptr(), out16.data_ptr(), *dims),
            lib.warp_bwd_bf16(img16.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                              d_coords16.data_ptr(), *dims)]
    if any(errs):
        raise RuntimeError(f"the other build's launch failed: {errs}")
    result = dict(fwd=out, bwd=d_coords, jvp=jvp, fwd_bf16=out16, bwd_bf16=d_coords16)
    for dt, key in ((torch.float32, "bwd_image"), (torch.bfloat16, "bwd_image_bf16")):
        result[key] = _other_image_grad(lib, route, coords, grad, (h, w), dt, pad)
    torch.cuda.synchronize()
    return result


def _this_outputs(image, coords, grad, tangent, pad):
    import torch

    from packnet_sfm_tpu_torch.ops import warp

    mode = ("zeros", "border")[pad]
    hw = tuple(image.shape[1:3])
    img16 = image.bfloat16()
    out = dict(fwd=warp.warp_fwd_cuda(image, coords, mode),
               bwd=warp.warp_bwd_cuda(image, coords, grad, mode)[1],
               jvp=warp.warp_jvp_cuda(image, coords, tangent, mode),
               fwd_bf16=warp.warp_fwd_cuda(img16, coords, mode),
               bwd_bf16=warp.warp_bwd_cuda(img16, coords, grad, mode)[1],
               bwd_image=warp.warp_bwd_image_cuda(coords, grad, hw, torch.float32, mode),
               bwd_image_bf16=warp.warp_bwd_image_cuda(coords, grad, hw, torch.bfloat16, mode))
    torch.cuda.synchronize()
    return out


def _image_grad_checks(image, coords, grad, pad):
    """warp_bwd_image in both dtypes against the plain version, its bits over
    three calls and under deterministic algorithms."""
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
    largest = max(want.abs().max().item(), 1e-30)
    rel = (d32 - want).abs().max().item() / largest
    # a bfloat16 spacing of each element of the plain version
    spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -120))) - 7)
    rel16 = ((d16.float() - want).abs() - spacing).clamp(min=0).max().item() / largest
    same = all(torch.equal(r, rs[0]) for rs in runs.values() for r in rs)
    rounded = torch.equal(d16, d32.bfloat16())
    ok = (rel <= TOL and rel16 <= TOL and same and rounded
          and bool(torch.isfinite(d32).all()))
    return dict(rel_err=rel, rel_err_bf16_beyond_its_spacing=rel16, bits_equal_over_calls=same,
                bf16_is_float32_rounded=rounded, ok=ok)


def main(argv=None) -> int:
    import torch

    from packnet_sfm_tpu_torch.ops import _cuda, warp

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other, route = _build(Path(argv[0]))
    device = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    cases, ok = [], True
    flagship = tuple((b, h, w, 3, h, w, mode) for b, h, w in FLAGSHIP
                     for mode in ("zeros", "border"))
    for case in CASES + ZOOM_IN + (COLLAPSED, OUTSIDE) + flagship:
        b, h, w, c, ho, wo, mode = case
        pad = warp.PADDING_MODES[mode]
        image, coords, grad, tangent = _inputs(gen, b, h, w, c, ho, wo, device,
                                               smooth=case in flagship + ZOOM_IN)
        if case == COLLAPSED:
            # 2000 samples clamped onto the bottom-right corner, the rest random
            coords.view(-1, 2)[:2000] = torch.tensor([3.0, 2.5], device=device)
        if case == OUTSIDE:
            coords += 3.0
        theirs = _other_outputs(other, route, image, coords, grad, tangent, pad)
        ours = _this_outputs(image, coords, grad, tangent, pad)
        equal = {k: bool(torch.equal(ours[k], theirs[k])) for k in ours}
        record = _image_grad_checks(image, coords, grad, pad)
        if case == OUTSIDE:
            record["d_image_all_zero"] = bool((ours["bwd_image"] == 0).all())
            record["ok"] &= record["d_image_all_zero"]
        ok &= all(equal.values()) and record["ok"]
        cases.append(dict(case=list(case), equal=equal, **record))
        print(json.dumps(cases[-1]), file=sys.stderr)

    times = []
    for b, h, w in FLAGSHIP:
        image, coords, grad, _ = _inputs(gen, b, h, w, 3, h, w, device, smooth=True)
        img16 = image.bfloat16()
        d_coords = torch.empty_like(coords)
        ours = _cuda.load("warp")

        def image_grad(lib, dtype, pad=0):
            if lib is other:
                return lambda: _other_image_grad(other, route, coords, grad, (h, w), dtype, pad)
            mode = ("zeros", "border")[pad]
            return lambda: warp.warp_bwd_image_cuda(coords, grad, (h, w), dtype, mode)

        def coords_only(lib, im, name):
            def launch():
                getattr(lib, name)(im.data_ptr(), coords.data_ptr(), grad.data_ptr(),
                                   d_coords.data_ptr(), b, h, w, 3, h, w, 0, _cuda.stream(image))
            return launch

        turns = (other, ours, other, ours)
        times.append(dict(
            shape=[b, h, w, 3],
            d_image_other_this_other_this_ms=[_time_ms(image_grad(lib, torch.float32))
                                              for lib in turns],
            d_image_bf16_other_this_other_this_ms=[_time_ms(image_grad(lib, torch.bfloat16))
                                                   for lib in turns],
            d_image_border_other_this_other_this_ms=[
                _time_ms(image_grad(lib, torch.float32, 1)) for lib in turns],
            **{f"d_coords_{name}_other_this_other_this_ms": [
                _time_ms(coords_only(lib, im, name)) for lib in turns]
               for name, im in (("warp_bwd", image), ("warp_bwd_bf16", img16))}))
        print(json.dumps(times[-1]), file=sys.stderr)
    print(json.dumps(dict(device=gpu, other_route=route[0], ok=ok, cases=cases, times=times)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
