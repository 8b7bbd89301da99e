"""Seeded inputs shared by the port's tests and ``chip_smoke.py``.

Inputs are made with numpy so that the JAX package and the port (and the
card and the CPU) see the same numbers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["quasi_definite"]


def quasi_definite(B: int, N: int, seed: int, skip: bool = True):
    """A batch of symmetric quasi-definite systems [[A, Cᵀ], [C, -D]] with
    A (n1, n1) and D positive definite, n1 = ⌈N/2⌉: the inertia the ρ ladder
    asks of a KKT matrix with nvar = n1.  With ``skip``, lane 0 has a zero
    first pivot and lane 1 a second pivot that is exactly zero after one
    elimination step, so the skipped-pivot rule runs.

    Returns float64 arrays ``W`` (B, N, N), ``rhs`` (B, N) and ``n1``."""
    rng = np.random.default_rng(seed)
    n1 = max(1, (N + 1) // 2)
    G = rng.normal(size=(B, N, N))
    S = G @ G.transpose(0, 2, 1) / N + np.eye(N)
    W = 0.15 * (G + G.transpose(0, 2, 1))
    W[:, :n1, :n1] = S[:, :n1, :n1]
    W[:, n1:, n1:] = -S[:, n1:, n1:]
    if skip and B > 1:
        W[0, 0, 0] = 0.0
    if skip and B > 2 and N >= 2:
        W[1, 0, :] = W[1, :, 0] = 0.0
        W[1, :2, :2] = 1.0
    return W, rng.normal(size=(B, N)), n1
