"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
into ``cannoles_tpu_torch/_build/`` (git-ignored), under a file name keyed
by a hash of the sources and flags, so a fresh checkout builds everything it
needs and a changed source is rebuilt.  A missing ``nvcc`` or a failed build
raises with the compiler's output; nothing falls back.  Nothing is built
when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["load", "BUILD_INFO"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = [_PKG / "csrc" / "fused_ldlt.cu"]
_BUILD_DIR = _PKG / "_build"
# --fmad=false: no contracted multiply-adds, so the kernel's arithmetic is
# the plain PyTorch version's operation for operation.
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIB = None
# filled by the first load(): library path, build seconds (0 when cached),
# and ptxas's register/shared-memory report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _build() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    lib = _BUILD_DIR / f"libcannoles_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, ptxas="(cached)")
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0, ptxas=proc.stderr)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            for name in ("cannoles_fused_ldlt_f32", "cannoles_fused_ldlt_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
