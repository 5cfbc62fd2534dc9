"""ctypes bindings for the native image decode (``image_pipeline.cpp``).

The port's own copy of the image half of ``packnet_sfm_tpu/native/
__init__.py``. The library is built with ``g++ -O3 ... -ljpeg -lpng`` at
first use, from this package's ``image_pipeline.cpp``, into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
keyed by a hash of the source. Nothing is built or loaded when this module
is imported.

Where the library does not build or load (no compiler, no libjpeg or libpng
headers), ``decode_image`` returns None and the readers decode with Pillow,
as in the JAX package. The two decoders can differ on a JPEG by a few
levels, so the fallback is not silent: the build's error is printed once,
and ``decoder()`` names the decoder in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "image_pipeline.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None        # why the library is unavailable, once known
_decode_tls = threading.local()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpacknet_image_{digest}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the source into ``out``; None on success, else the error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-ljpeg", "-lpng", "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        return f"{' '.join(cmd)} exited with {proc.returncode}:\n{proc.stderr[-2000:]}"
    os.replace(tmp, out)
    return None


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None where it is unavailable
    (the first such call prints why)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        out = library_path()
        err = None if out.exists() else _build(out)
        if err is None:
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                err = f"loading {out}: {e}"
        if err is not None:
            _error = err
            print(f"native image decode unavailable, decoding with Pillow: {err}", flush=True)
            return None
        lib.pn_load_batch.restype = ctypes.c_int
        lib.pn_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.pn_decode_image.restype = ctypes.c_int
        lib.pn_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.pn_thread_count.restype = ctypes.c_int
        lib.pn_thread_count.argtypes = []
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def decoder() -> str:
    """'native' where the library loads (building it if needed), else
    'pillow', the decoder that ``datasets/kitti.load_image_u8`` then uses."""
    return "native" if native_available() else "pillow"


def build_error() -> Optional[str]:
    """Why the native library is unavailable (None where it loaded)."""
    load_native()
    return _error


def load_image_batch(paths: Sequence[str], height: int, width: int) -> np.ndarray:
    """Threaded native decode+resize of a file batch -> [N, H, W, 3] f32."""
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.pn_load_batch(
        arr, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise IOError(f"{failures}/{n} images failed to decode")
    return out


def decode_image(path: str) -> Optional[np.ndarray]:
    """Native single-image decode at source resolution -> [H, W, 3] u8.

    Thread-safe (a scratch buffer per thread); returns None where the
    native library is unavailable or the file does not decode, so that the
    caller can fall back to Pillow.
    """
    lib = load_native()
    if lib is None:
        return None
    buf = getattr(_decode_tls, "buf", None)
    if buf is None:
        buf = _decode_tls.buf = np.empty(32 * 1024 * 1024, np.uint8)  # ~3300x3300 RGB
    w = ctypes.c_int()
    h = ctypes.c_int()

    def decode(buf):
        return lib.pn_decode_image(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size, ctypes.byref(w), ctypes.byref(h))

    rc = decode(buf)
    if rc == -2:  # buffer too small: grow to the image's size and retry
        buf = _decode_tls.buf = np.empty(h.value * w.value * 3, np.uint8)
        rc = decode(buf)
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()
