"""Dense unpivoted LDLᵀ and eigh backends with inertia, batch-leading.

PyTorch counterpart of ``cannoles_tpu/ops/ldlt.py``.  Every function takes a
leading batch axis: matrices are (B, N, N), vectors (B, N).

* ``ldlt_factor`` eliminates in the fixed order k = 0..N-1.  On the CPU it
  runs the same operations in host C++ (``csrc/ldlt_exact.cpp``, built by
  ``g++`` at first use and called as the op ``cannoles::ldlt_factor_host``,
  so that a traced segment records one node): bit for bit the PyTorch loop
  below, which runs on a card and wherever ``g++`` cannot build it.  A pivot with
  |d_k| ≤ eig_tol is skipped: its inverse is 0, its L column is zeroed and it
  makes no trailing update, but the raw pivot is recorded so the inertia test
  fails and the caller's ρ ladder retries.  The JAX package blocks the
  elimination into panels (and loops over them for N ≥ 256, to bound XLA
  compile time); here one column loop serves every N.  The order of
  elimination is the same, so the pivots agree to rounding.
* ``ldlt_solve`` applies one step of iterative refinement below float64, as
  the JAX version does.
* ``eigh_factor``/``eigh_solve`` give exact inertia (the MA57 analog).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = [
    "Factorization",
    "ldlt_factor",
    "ldlt_factor_torch",
    "ldlt_solve",
    "eigh_factor",
    "eigh_solve",
    "inertia_success",
    "factorize",
    "factor_solve",
    "safe_inverse",
]


class Factorization(NamedTuple):
    """Either (L, d) for LDLᵀ or (V, w) for eigh: (B, N, N) + (B, N)."""

    mat: torch.Tensor
    vec: torch.Tensor


def safe_inverse(d, eig_tol: float):
    """1/d where |d| > eig_tol, else 0 (the skipped-pivot rule)."""
    ok = d.abs() > eig_tol
    return torch.where(ok, 1.0 / torch.where(ok, d, 1.0), 0.0)


# the host library's functions by dtype, or False where it cannot be built
_HOST = None
_HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-ffp-contract=off", "-fno-fast-math"]


def _host_functions():
    global _HOST
    if _HOST is None:
        from . import _native

        try:
            lib = _native.library("ldlt_exact.cpp", _HOST_FLAGS)
        except (RuntimeError, OSError):
            _HOST = False
            return _HOST
        args = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int, ctypes.c_double]
        _HOST = {dt: _native.function(lib, f"cannoles_ldlt_exact_{s}", args, restype=None)
                 for dt, s in ((torch.float64, "f64"), (torch.float32, "f32"))}
    return _HOST


@torch.library.custom_op("cannoles::ldlt_factor_host", mutates_args=())
def _ldlt_factor_host(A: torch.Tensor, eig_tol: float) -> tuple[torch.Tensor, torch.Tensor]:
    A = A.contiguous()
    L = torch.empty_like(A)
    d = A.new_empty(A.shape[:-1])
    if A.numel():
        _host_functions()[A.dtype](A.data_ptr(), L.data_ptr(), d.data_ptr(), A.shape[0], A.shape[-1],
                                   float(eig_tol))
    return L, d


def ldlt_factor(A: torch.Tensor, eig_tol: float) -> Factorization:
    """Unpivoted LDLᵀ of a batch of symmetric (N, N) matrices: unit-lower L
    and the raw pivots d.  Column k updates only the trailing block
    W[k+1:, k+1:], the only entries that later columns read, so that a
    pivot d_k is the diagonal entry that no later column touches."""
    if A.device.type == "cpu" and A.dtype in (torch.float32, torch.float64) and _host_functions():
        return Factorization(*torch.ops.cannoles.ldlt_factor_host(A, float(eig_tol)))
    return ldlt_factor_torch(A, eig_tol)


def ldlt_factor_torch(A: torch.Tensor, eig_tol: float) -> Factorization:
    """``ldlt_factor`` in PyTorch operations (the card's, and the host
    library's reference)."""
    Bt, N, _ = A.shape
    W = A.clone()
    L = torch.eye(N, dtype=A.dtype, device=A.device).expand(Bt, N, N).clone()
    for k in range(N - 1):
        dk = W[:, k, k]
        col = W[:, k + 1:, k] * safe_inverse(dk, eig_tol)[:, None]
        L[:, k + 1:, k] = col + 0.0  # as the unit diagonal is added to the column: -0.0 → +0.0
        W[:, k + 1:, k + 1:] -= (dk[:, None] * col)[:, :, None] * col[:, None, :]
    return Factorization(L, torch.diagonal(W, dim1=-2, dim2=-1).clone())


def ldlt_solve(fac: Factorization, rhs: torch.Tensor, eig_tol: float) -> torch.Tensor:
    """Solve A x = rhs given A = L D Lᵀ; one refinement step below float64."""
    L, d = fac
    dinv = safe_inverse(d, eig_tol)
    Lt = L.transpose(-2, -1)

    def solve_once(b):
        y = torch.linalg.solve_triangular(L, b[..., None], upper=False, unitriangular=True)
        y = y * dinv[..., None]
        return torch.linalg.solve_triangular(Lt, y, upper=True, unitriangular=True)[..., 0]

    x = solve_once(rhs)
    if L.dtype.itemsize < 8:
        r = rhs - (L @ (d * (Lt @ x[..., None])[..., 0])[..., None])[..., 0]
        x = x + solve_once(r)
    return x


def eigh_factor(A: torch.Tensor, eig_tol: float) -> Factorization:
    w, V = torch.linalg.eigh(A)
    return Factorization(V, w)


def eigh_solve(fac: Factorization, rhs: torch.Tensor, eig_tol: float) -> torch.Tensor:
    V, w = fac
    y = (V.transpose(-2, -1) @ rhs[..., None])[..., 0] * safe_inverse(w, eig_tol)
    return (V @ y[..., None])[..., 0]


def inertia_success(vec: torch.Tensor, mat: torch.Tensor, nvar: int, eig_tol: float):
    """Per lane: exactly ``nvar`` pivots/eigenvalues above eig_tol, none
    within eig_tol of zero, and everything finite."""
    pos = (vec > eig_tol).sum(-1)
    zer = (vec.abs() <= eig_tol).sum(-1)
    finite = torch.isfinite(vec).all(-1) & torch.isfinite(mat).flatten(1).all(-1)
    return (pos == nvar) & (zer == 0) & finite


def factorize(A: torch.Tensor, eig_tol: float, nvar: int, backend: str = "ldlt", nb: int = 32):
    """Factor and test the inertia of each lane: (factorization, success
    (B,)).  ``backend`` ∈ {'ldlt', 'eigh'}; ``nb`` (the JAX package's panel
    width) is accepted so that its calls carry over, and read by neither."""
    if backend == "eigh":
        fac = eigh_factor(A, eig_tol)
    elif backend == "ldlt":
        fac = ldlt_factor(A, eig_tol)
    else:
        raise ValueError(f"unknown linsolve backend {backend!r}")
    return fac, inertia_success(fac.vec, fac.mat, nvar, eig_tol)


def factor_solve(fac: Factorization, rhs: torch.Tensor, eig_tol: float, backend: str = "ldlt") -> torch.Tensor:
    """Solve with a factorization of ``factorize``'s ``backend``."""
    if backend == "eigh":
        return eigh_solve(fac, rhs, eig_tol)
    return ldlt_solve(fac, rhs, eig_tol)
