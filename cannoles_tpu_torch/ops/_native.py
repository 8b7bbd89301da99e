"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
of its own with a plain C interface, loaded with ctypes; the ``nvcc``
processes of all sources run at once.  The build runs at first use, into
``cannoles_tpu_torch/_build/`` (git-ignored), under a file name keyed by a
hash of the source and flags, so a fresh checkout builds everything it
needs and a changed source is rebuilt.  A missing ``nvcc`` or a failed build
raises with the compiler's output; nothing falls back.  Nothing is built
when the package is imported.  ``load()`` builds the kernels of every
solver's path; a kernel that only one engine reaches (``_ON_USE``) is built
and loaded by ``load_source`` at that engine's first launch, so that the
paths that never reach it do not wait for its build.
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
import types

__all__ = ["load", "load_source", "BUILD_INFO"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG / "_build"
# --fmad=false: no contracted multiply-adds, so the kernels' elementwise
# arithmetic is the plain PyTorch versions' operation for operation.
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# source -> {exported function: argtypes}; every function returns an int
# (cudaGetLastError() after its launches, or a constant of the kernel)
_SOURCES = {
    "fused_ldlt.cu": {
        **{
            name: [_P, _P, _P, _P, _I, _I, _D, _I, _P]
            for name in ("cannoles_fused_ldlt_f32", "cannoles_fused_ldlt_f64")
        },
        "cannoles_fused_ldlt_thread_max_n": [],
    },
    "block_chol.cu": {
        name: [_P, _P, _P, _P, _I, _I, _I, _D, _P]
        for name in ("cannoles_chol_f32", "cannoles_chol_f64")
    },
    "bank_copy.cu": {
        "cannoles_bank_copy": [_P, _I, _I, _P],
        "cannoles_bank_copy_cap": [],
        "cannoles_bank_copy_stage_bytes": [],
    },
}

# built at first use by ``load_source``: the Schur engine's pair kernel and
# its products over observations (core/ba.py on an observation list)
_ON_USE = {
    "schur_pairs.cu": {
        name: [_P, _P, _P, _P, _P, _I, _I, _P, _P]
        for name in ("cannoles_schur_pairs_f32", "cannoles_schur_pairs_f64")
    },
    "obs_products.cu": {
        name: [_I] * 6 + [_P] * 13
        for name in ("cannoles_obs_products_f32", "cannoles_obs_products_f64")
    },
}

_LOCK = threading.Lock()
_LIB = None
_ON_USE_LIBS: dict = {}
# filled by the first load(): per source, the library path, the build
# seconds (0 when cached) and ptxas's register/shared-memory report; and
# the wall seconds of the whole (parallel) build
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _build(names) -> dict:
    """Build every source of ``names`` not built yet, all nvcc processes at
    once; returns {source name: library path}."""
    libs, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src = _PKG / "csrc" / name
        lib = _lib_path(src)
        libs[name] = lib
        if lib.exists():
            BUILD_INFO[name] = dict(path=str(lib), seconds=0.0, ptxas="(cached)")
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs[name] = (proc, cmd, tmp, lib)
    failed = []
    for name, (proc, cmd, tmp, lib) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            continue
        os.replace(tmp, lib)
        BUILD_INFO[name] = dict(path=str(lib), seconds=time.perf_counter() - t0, ptxas=err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def _bind(libs: dict, table: dict) -> types.SimpleNamespace:
    fns = {"_libs": []}  # the CDLLs stay referenced while loaded
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fns["_libs"].append(lib)
        for fn_name, argtypes in table[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fn_name] = fn
    return types.SimpleNamespace(**fns)


def load() -> types.SimpleNamespace:
    """The kernels' C functions as attributes, every library of
    ``_SOURCES`` built on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            _LIB = _bind(_build(_SOURCES), _SOURCES)
            BUILD_INFO["wall_seconds"] = time.perf_counter() - t0
        return _LIB


def load_source(name: str) -> types.SimpleNamespace:
    """The C functions of one source of ``_ON_USE``, built and loaded on
    its first call."""
    with _LOCK:
        if name not in _ON_USE_LIBS:
            _ON_USE_LIBS[name] = _bind(_build([name]), _ON_USE)
        return _ON_USE_LIBS[name]
