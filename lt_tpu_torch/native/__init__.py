"""ctypes bindings of the native C++ image pipeline (the port's own copy of
``lt_tpu/native``; the same API).

Builds ``image_pipeline.cc`` with ``g++ -O3 -shared -fPIC -ljpeg
-lpthread`` at first use into ``build/native/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source, and exposes:

- :func:`decode_jpeg`: libjpeg decode to a BGR uint8 array (``cv2.imread``'s
  channel order);
- :func:`process_image`: fused zero-padded crop + area resize + ImageNet
  normalization;
- :class:`NativeBatchLoader`: thread-pooled decode and process of a whole
  multi-view batch in one call.

:func:`available` is False where the library cannot be built (no g++, or
no libjpeg headers), and :func:`build_error` says why; the datasets then
read with cv2 and say so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "image_pipeline.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lib = None
_lock = threading.Lock()
_build_error: Optional[str] = None


def lib_path() -> Path:
    """Where the library of the current source is built."""
    h = hashlib.sha1(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libltimage-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the library to ``out``; returns an error string on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:   # no g++, etc.
        return str(e)
    if proc.returncode != 0:
        return proc.stderr.strip()[-2000:] or f"g++ exit {proc.returncode}"
    os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            _build_error = _build(out)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            _build_error = str(e)
            return None

        lib.lt_loader_create.restype = ctypes.c_void_p
        lib.lt_loader_create.argtypes = [ctypes.c_int]
        lib.lt_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.lt_decode_jpeg.restype = ctypes.c_int
        lib.lt_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.lt_process_image.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.lt_load_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None where it loaded)."""
    _load()
    return _build_error


def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """Decode a JPEG to (H, W, 3) BGR uint8, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.lt_decode_jpeg(path.encode(), None, 0, ctypes.byref(h),
                          ctypes.byref(w)) != 0:
        return None
    buf = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.lt_decode_jpeg(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size, ctypes.byref(h), ctypes.byref(w))
    return buf if rc == 0 else None


def process_image(image: np.ndarray, bbox, out_shape,
                  normalize: bool = True) -> Optional[np.ndarray]:
    """Fused crop + resize + normalize of an HWC uint8 image."""
    lib = _load()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, np.uint8)
    out = np.empty((out_shape[0], out_shape[1], 3), np.float32)
    left, upper, right, lower = (int(v) for v in bbox)
    lib.lt_process_image(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        image.shape[0], image.shape[1], left, upper, right, lower,
        out_shape[0], out_shape[1], int(normalize),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


class NativeBatchLoader:
    """Thread-pooled JPEG -> float32 pipeline for whole multi-view batches."""

    def __init__(self, n_threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._handle = lib.lt_loader_create(n_threads)

    def close(self):
        if self._handle:
            self._lib.lt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def load(self, paths, bboxes, out_shape, normalize: bool = True):
        """Decode and process ``len(paths)`` JPEGs in parallel.

        Returns (batch (N, H, W, 3) float32, ok (N,) bool).
        """
        n = len(paths)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        bboxes = np.ascontiguousarray(bboxes, np.int32)
        out = np.empty((n, out_shape[0], out_shape[1], 3), np.float32)
        ok = np.zeros((n,), np.int32)
        self._lib.lt_load_batch(
            self._handle, arr,
            bboxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            out_shape[0], out_shape[1], int(normalize),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out, ok.astype(bool)
