"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``.  Libraries go to ``build/kernels/`` at
the repository root (listed in ``.gitignore``), named by a hash of the
sources, so a changed source rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module without
a CUDA toolkit.  A build that fails raises; there is no fallback.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("unproject_agg", "conv3d_fused", "upsample3d_2x", "max_pool3d_2x",
           "sample_views_t", "sample_views_grad_t", "sample_views",
           "sample_views_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

#: Launches per kernel since the last :func:`reset_launches`.  Each wrapper
#: adds one where it launches its kernel, and nowhere else.
LAUNCHES = dict.fromkeys(SOURCES, 0)
#: nvcc's output (ptxas register / shared-memory report) per built source.
BUILD_LOG: dict = {}
_LIBS: dict = {}

ptr = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "lt_tpu_torch are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every named source not yet built, one ``nvcc`` per source
    running in parallel.  Returns the wall seconds taken; raises on error."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def _lib(name: str):
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.ltk_error_string.argtypes = [i32]
        lib.ltk_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def launch(name: str, fn: str, device: torch.device, argtypes,
           *args) -> None:
    """Call C entry point ``fn`` of kernel library ``name`` on ``device``'s
    current stream (appended as the last argument) and count the launch.

    Every pointer and the stream are ``c_void_p``: without ``argtypes``
    ctypes would pass a Python int as a 32-bit C int and cut the pointer.
    The entry point returns ``cudaGetLastError()``; non-zero raises.
    """
    lib = _lib(name)
    cfn = getattr(lib, fn)
    cfn.argtypes = list(argtypes) + [ptr]
    cfn.restype = i32
    with torch.cuda.device(device):
        err = cfn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {err} "
                           f"({lib.ltk_error_string(err).decode()})")
    LAUNCHES[name] += 1


#: The element types a kernel may take, and their codes in the C interface
#: (``common.cuh``: kLtkF32, kLtkBF16).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)


def check_cuda(t: torch.Tensor, name: str, ndim: int = None,
               dtypes=F32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    (float32 unless the kernel also takes bfloat16 there)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: kernel takes {want}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
