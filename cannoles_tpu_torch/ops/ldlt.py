"""Dense unpivoted LDLᵀ and eigh backends with inertia, batch-leading.

PyTorch counterpart of ``cannoles_tpu/ops/ldlt.py``.  Every function takes a
leading batch axis: matrices are (B, N, N), vectors (B, N).

* ``ldlt_factor`` eliminates in the fixed order k = 0..N-1.  A pivot with
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

from typing import NamedTuple

import torch

__all__ = [
    "Factorization",
    "ldlt_factor",
    "ldlt_solve",
    "eigh_factor",
    "eigh_solve",
    "inertia_success",
    "safe_inverse",
]


class Factorization(NamedTuple):
    """Either (L, d) for LDLᵀ or (V, w) for eigh: (B, N, N) + (B, N)."""

    mat: torch.Tensor
    vec: torch.Tensor


def safe_inverse(d, eig_tol: float):
    """1/d where |d| > eig_tol, else 0 (the skipped-pivot rule)."""
    ok = d.abs() > eig_tol
    return torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)), torch.zeros_like(d))


def ldlt_factor(A: torch.Tensor, eig_tol: float) -> Factorization:
    """Unpivoted LDLᵀ of a batch of symmetric (N, N) matrices: unit-lower L
    and the raw pivots d."""
    Bt, N, _ = A.shape
    W = A.clone()
    L = torch.zeros_like(A)
    d = A.new_zeros((Bt, N))
    rows = torch.arange(N, device=A.device)
    for k in range(N):
        dk = W[:, k, k]
        col = torch.where(rows > k, W[:, :, k] * safe_inverse(dk, eig_tol)[:, None], 0.0)
        L[:, :, k] = col + (rows == k).to(A.dtype)
        d[:, k] = dk
        W = W - dk[:, None, None] * col[:, :, None] * col[:, None, :]
    return Factorization(L, d)


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
