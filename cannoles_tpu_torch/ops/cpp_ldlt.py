"""The host C++ LDLᵀ backend (``linsolve="cpp"``), bound with ctypes.

Port of ``cannoles_tpu/ops/cpp_ldlt.py``.  The source is the port's own
copy, ``csrc/ldlt_host.cpp``; ``ops/_native.py`` compiles it with the JAX
package's flags (``g++ -O3 -march=native -shared -fPIC -fopenmp``) at first
use, into ``cannoles_tpu_torch/_build/`` (git-ignored), under a file name
keyed by a hash of the source, the flags and the host's CPU.  A missing
``g++`` or a failed build raises with the compiler's output.

This backend runs on the host CPU by design, as the JAX package's
``pure_callback`` does: W and rhs are copied to host memory as float64,
row-major and contiguous, factored and solved there
(``cannoles_ldlt_factor_solve_batch`` over the lanes, OpenMP across them),
and x is copied back to W's device and dtype.  A CUDA tensor makes that
round trip explicitly; it is the backend's meaning, not a fallback.
"""

from __future__ import annotations

import functools
from ctypes import c_double, c_int, c_void_p

import torch

from . import _native

__all__ = ["cpp_available", "cpp_ldlt_factor_solve", "lib_path", "native_lib_path"]

_SRC = _native.CSRC / "ldlt_host.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]


def lib_path():
    """Where the library for this source, these flags and this CPU lives."""
    return _native.lib_path(_SRC, _FLAGS)


def native_lib_path():
    """Where this host's build of ``csrc/ldlt_host.cpp`` lives (``lib_path``)."""
    return lib_path()


@functools.lru_cache(maxsize=None)
def _load():
    return _native.function(_native.library(_SRC.name, _FLAGS), "cannoles_ldlt_factor_solve_batch",
                            [c_int, c_int, c_int, c_double] + [c_void_p] * 5, restype=None)


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
    fn = _load()
    host = dict(device="cpu", dtype=torch.float64)
    Wh = Wb.detach().to(**host).contiguous()
    rh = rb.detach().to(**host).contiguous()
    x = torch.zeros((B, N), **host)
    d = torch.zeros((B, N), **host)
    ok = torch.zeros((B,), dtype=torch.int32)
    if B > 0:
        fn(B, N, int(nvar), float(eig_tol), Wh.data_ptr(), rh.data_ptr(), x.data_ptr(), d.data_ptr(), ok.data_ptr())
    x = x.to(device=W.device, dtype=W.dtype)
    success = (ok != 0).to(W.device)
    return (x[0], success[0]) if single else (x, success)
