"""The host C++ LDLᵀ backend (``linsolve="cpp"``), bound with ctypes.

Port of ``cannoles_tpu/ops/cpp_ldlt.py``.  The source is the port's own
copy, ``csrc/ldlt_host.cpp``; it is compiled with the JAX package's flags
(``g++ -O3 -march=native -shared -fPIC -fopenmp``) at first use, into
``cannoles_tpu_torch/_build/`` (git-ignored), under a file name keyed by a
hash of the source, the flags and the host's CPU (model name and flags from
``/proc/cpuinfo``): the build directory may travel with a checkout to
another machine, where a ``-march=native`` library built for this one could
die on an illegal instruction.  A missing ``g++`` or a failed build raises
with the compiler's output.  ``ops/ldlt.py`` builds ``csrc/ldlt_exact.cpp``
(its exact host LDLᵀ) with the same helpers and its own flags.

This backend runs on the host CPU by design, as the JAX package's
``pure_callback`` does: W and rhs are copied to host memory as float64,
row-major and contiguous, factored and solved there
(``cannoles_ldlt_factor_solve_batch`` over the lanes, OpenMP across them),
and x is copied back to W's device and dtype.  A CUDA tensor makes that
round trip explicitly; it is the backend's meaning, not a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["cpp_available", "cpp_ldlt_factor_solve", "lib_path", "native_lib_path"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "ldlt_host.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]

_LOCK = threading.Lock()
_LIB = None


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


def lib_path(src: pathlib.Path = _SRC, flags=_FLAGS) -> pathlib.Path:
    """Where the library for this source, these flags and this CPU lives."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_cpu_id().encode())
    return _BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def native_lib_path() -> pathlib.Path:
    """Where this host's build of ``csrc/ldlt_host.cpp`` lives (``lib_path``)."""
    return lib_path()


def _build(lib: pathlib.Path, src: pathlib.Path = _SRC, flags=_FLAGS) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build {src.name}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, *flags, str(src), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}): {' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = lib_path()
            if not lib.exists():
                _build(lib)
            cdll = ctypes.CDLL(str(lib))
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            cdll.cannoles_ldlt_factor_solve_batch.restype = None
            cdll.cannoles_ldlt_factor_solve_batch.argtypes = [I, I, I, D, P, P, P, P, P]
            _LIB = cdll
        return _LIB


def cpp_available() -> bool:
    """Whether the library builds (or is built) and loads on this host."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def cpp_ldlt_factor_solve(W: torch.Tensor, rhs: torch.Tensor, nvar: int, eig_tol: float):
    """Factor and solve each lane of W (B, N, N) x = rhs (B, N) on the host;
    a single system (N, N), (N,) is the case B = 1 without the batch axis.

    Returns (x, success) on W's device: x in W's dtype (zero where an
    elimination step was skipped), success the C++ flag: exactly ``nvar``
    pivots above ``eig_tol``, none within it, x and the pivots finite."""
    single = W.dim() == 2
    Wb = W.unsqueeze(0) if single else W
    rb = rhs.unsqueeze(0) if single else rhs
    if Wb.dim() != 3 or Wb.shape[-1] != Wb.shape[-2] or tuple(rb.shape) != tuple(Wb.shape[:2]):
        raise ValueError(f"cpp_ldlt_factor_solve: W {tuple(W.shape)} and rhs {tuple(rhs.shape)} "
                         "are not (B, N, N) and (B, N)")
    B, N = Wb.shape[0], Wb.shape[-1]
    if B >= 2**31 or N * N >= 2**31:
        raise ValueError(f"cpp_ldlt_factor_solve: B = {B}, N = {N} beyond the library's int sizes")
    lib = _load()
    host = dict(device="cpu", dtype=torch.float64)
    Wh = Wb.detach().to(**host).contiguous()
    rh = rb.detach().to(**host).contiguous()
    x = torch.zeros((B, N), **host)
    d = torch.zeros((B, N), **host)
    ok = torch.zeros((B,), dtype=torch.int32)
    if B > 0:
        lib.cannoles_ldlt_factor_solve_batch(B, N, int(nvar), float(eig_tol), Wh.data_ptr(),
                                             rh.data_ptr(), x.data_ptr(), d.data_ptr(), ok.data_ptr())
    x = x.to(device=W.device, dtype=W.dtype)
    success = (ok != 0).to(W.device)
    return (x[0], success[0]) if single else (x, success)
