"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the source, then
loaded with ``ctypes``. Nothing is built or loaded when this module is
imported. ``check_tensor`` and ``stream`` are what every kernel wrapper does
before a launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every exported launcher, by source name.
SIGNATURES = {
    "softargmax": {
        "softargmax_fwd": [_P] * 6 + [_I] * 4 + [_F, _P],
        "softargmax_bwd": [_P] * 10 + [_I] * 4 + [_F, _P],
        "softargmax_fwd_band": [_P] * 6 + [_I] * 8 + [_F, _P],
        "softargmax_bwd_band": [_P] * 10 + [_I] * 8 + [_F, _P],
    },
    "warp": {
        "warp_fwd": [_P] * 3 + [_I] * 7 + [_P],
        "warp_bwd": [_P] * 4 + [_I] * 7 + [_P],
        "warp_fwd_bf16": [_P] * 3 + [_I] * 7 + [_P],
        "warp_bwd_bf16": [_P] * 4 + [_I] * 7 + [_P],
        "warp_bwd_image_count": [_P] * 2 + [_I] * 6 + [_P],
        "warp_bwd_image": [_P] * 7 + [_I] * 7 + [_P],
        "warp_bwd_image_bf16": [_P] * 7 + [_I] * 7 + [_P],
        "warp_jvp": [_P] * 4 + [_I] * 7 + [_P],
        "launch_floor": [_P],
    },
}

_loaded: dict = {}


def check_tensor(name: str, t: torch.Tensor, shape, dtypes=(torch.float32,)) -> None:
    """Raise unless ``t`` is what the kernels take: a contiguous CUDA tensor
    of ``shape`` and one of ``dtypes`` (float32 unless said otherwise)."""
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous():
        kinds = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be a contiguous {kinds} CUDA tensor, got "
                         f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_floor(device) -> None:
    """Launch a kernel that does nothing (``csrc/warp.cu``) on ``device``'s
    current stream: what a measurement of the launch itself times."""
    lib = load("warp")
    with torch.cuda.device(device):
        err = lib.launch_floor(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_floor failed: cudaError {err}")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named sources (default: every ``csrc/*.cu``) not built yet.

    One ``nvcc`` per source, all started together. Returns
    {name: (seconds, compiler output)}; raises with the compiler's output if
    one fails. ``verbose`` adds ``-Xptxas -v`` (registers, spills).
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, log)
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its launchers typed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
