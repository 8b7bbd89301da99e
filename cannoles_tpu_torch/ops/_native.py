"""Build and load the package's native libraries (``csrc/``).

One routine builds every source into a shared library of its own with a
plain C interface, loaded with ctypes: a CUDA kernel (``*.cu``) with
``nvcc`` for ``sm_90a`` and :data:`NVCC_FLAGS`, host C++ (``*.cpp``) with
``g++`` and its caller's flags.  The build runs at first use, into
``cannoles_tpu_torch/_build/`` (git-ignored), under a file name keyed by a
hash of the source and flags, and for ``g++`` also of the host's CPU (model
name and flags from ``/proc/cpuinfo``): the build directory may travel with
a checkout to another machine, where a ``-march=native`` library built for
this one could die on an illegal instruction.  So a fresh checkout builds
everything it needs and a changed source is rebuilt.  A missing compiler or
a failed build raises with the compiler's output; nothing falls back.
Nothing is built when the package is imported.

``load()`` builds the kernels of every solver's path (``_SOURCES``), their
``nvcc`` processes all at once; a library that only one engine or backend
reaches is built and loaded by :func:`library` at its first use, so that
the paths that never reach it do not wait for its build.  Each wrapper in
``ops/`` binds the C functions it calls (:func:`function`), with their
argument types beside the call.
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

__all__ = ["load", "library", "function", "lib_path", "build", "CSRC", "NVCC_FLAGS", "BUILD_INFO"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
# --fmad=false: no contracted multiply-adds, so the kernels' elementwise
# arithmetic is the plain PyTorch versions' operation for operation.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the CUDA kernels of every solver's path, built together by ``load()``
_SOURCES = ("fused_ldlt.cu", "block_chol.cu", "bank_copy.cu")

_LOCK = threading.RLock()
_LIBS: dict = {}  # source name -> its loaded CDLL (kept referenced while loaded)
# per source built, the library path, the build seconds (0 when cached) and
# the compiler's report (ptxas's registers and shared memory for nvcc); and
# the wall seconds of the first load()'s (parallel) build
BUILD_INFO: dict = {}


def _compiler(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    if name == "nvcc":
        cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")
    raise RuntimeError(f"{name} not found on PATH: cannot build the host libraries")


def _cpu_id() -> str:
    """The host CPU's model name and flags (what -march=native reads)."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return os.uname().machine
    keep = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags", "Features", "CPU part") and key not in keep:
            keep[key] = value.strip()
    return repr(sorted(keep.items()))


def _spec(src: pathlib.Path, flags=None):
    """(compiler, flags) of a source: nvcc and ``NVCC_FLAGS`` for ``.cu``, g++
    and ``flags`` otherwise."""
    return ("nvcc", NVCC_FLAGS) if src.suffix == ".cu" else ("g++", list(flags))


def lib_path(src: pathlib.Path, flags=None, build_dir: pathlib.Path = _BUILD_DIR) -> pathlib.Path:
    """Where the library of ``src`` built with ``flags`` (``NVCC_FLAGS`` for
    a ``.cu`` source) lives."""
    compiler, flags = _spec(src, flags)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    if compiler == "g++":
        h.update(_cpu_id().encode())
    return pathlib.Path(build_dir) / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(sources, build_dir: pathlib.Path = _BUILD_DIR) -> list:
    """Build every ``(source path, flags)`` of ``sources`` not built yet into
    ``build_dir``, all compilers at once (each writes a temporary file,
    renamed when it succeeds); returns the library paths."""
    libs, procs = [], []
    t0 = time.perf_counter()
    for src, flags in sources:
        lib = lib_path(src, flags, build_dir)
        libs.append(lib)
        if lib.exists():
            BUILD_INFO[src.name] = dict(path=str(lib), seconds=0.0, ptxas="(cached)")
            continue
        compiler, flags = _spec(src, flags)
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_compiler(compiler), *flags, "-o", str(tmp), str(src)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                      cmd, tmp, lib))
    failed = []
    for src, proc, cmd, tmp, lib in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{pathlib.Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            continue
        os.replace(tmp, lib)
        BUILD_INFO[src.name] = dict(path=str(lib), seconds=time.perf_counter() - t0, ptxas=err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load() -> None:
    """Build and load the libraries of ``_SOURCES`` (on the first call)."""
    with _LOCK:
        if _SOURCES[0] not in _LIBS:
            t0 = time.perf_counter()
            libs = [ctypes.CDLL(str(lib)) for lib in build([(CSRC / name, None) for name in _SOURCES])]
            _LIBS.update(zip(_SOURCES, libs))
            BUILD_INFO["wall_seconds"] = time.perf_counter() - t0


def library(name: str, flags=None) -> ctypes.CDLL:
    """The library of ``csrc/<name>``, built and loaded on the first call: a
    ``.cu`` source with ``NVCC_FLAGS`` (one of ``_SOURCES`` by ``load()``,
    with the others), a ``.cpp`` source with ``g++`` and ``flags`` (one set
    of flags a source)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name in _SOURCES:
            load()
        elif name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build([(CSRC / name, flags)])[0]))
        return _LIBS[name]


def function(lib: ctypes.CDLL, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of ``lib``, with its argument and return
    types declared."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn
