"""Scalable equality-constrained NLS battery in the Lukšan–Vlček style.

Port of ``cannoles_tpu/models/lvcon.py``: chained partially separable
least-squares objectives × {trigonometric-exponential, Broyden tridiagonal,
Broyden banded} constraint systems on the interior nodes (L. Lukšan &
J. Vlček, ICS AS CR technical report 767, 1999).  Every function is written
in slice/gather form with no Python loop over n, so one problem scales with
n.  These are re-derived from the report's problem classes, so tests
certify solutions with the solver-independent KKT oracle
(:mod:`cannoles_tpu_torch.utils.kkt`).

Builders take ``dtype=None`` (float64) and ``device=None`` (the card;
``"cpu"`` builds on the CPU).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..problem import NLSProblem, default_device, nls_problem

__all__ = ["lvcon_problem", "lvcon_suite", "LVCON_NAMES", "LVConSpec"]


class LVConSpec(NamedTuple):
    name: str
    build: Callable[..., NLSProblem]  # build(n, dtype=None, device=None)
    default_n: int


# ----------------------------------------------------------------------
# chained least-squares objectives (residual vectors)
# ----------------------------------------------------------------------
def _res_chained_rosenbrock(x):
    # sum_{i<n} 100(x_i^2 - x_{i+1})^2 + (x_i - 1)^2
    return torch.cat([10.0 * (x[:-1] ** 2 - x[1:]), x[:-1] - 1.0])


def _res_chained_wood(x):
    # overlapping Wood groups on (x_i..x_{i+3}), i = 1, 3, 5, ... (odd)
    a, b, c, d = x[0:-3:2], x[1:-2:2], x[2:-1:2], x[3::2]
    s90, s10 = float(np.sqrt(90.0)), float(np.sqrt(10.0))
    return torch.cat(
        [
            10.0 * (a**2 - b),
            a - 1.0,
            s90 * (c**2 - d),
            c - 1.0,
            s10 * (b + d - 2.0),
            (b - d) / s10,
        ]
    )


def _res_chained_powell(x):
    # overlapping Powell-singular groups on (x_i..x_{i+3}), i odd
    a, b, c, d = x[0:-3:2], x[1:-2:2], x[2:-1:2], x[3::2]
    s5, s10 = float(np.sqrt(5.0)), float(np.sqrt(10.0))
    return torch.cat([a + 10.0 * b, s5 * (c - d), (b - 2.0 * c) ** 2, s10 * (a - d) ** 2])


def _res_chained_exponential(x):
    a, b = x[:-1], x[1:]
    return torch.cat([(torch.exp(a) - b) ** 2, 10.0 * (b - 1.0)])


# ----------------------------------------------------------------------
# constraint systems on interior nodes k = 2..n-1 (1-based), p = n-2
# ----------------------------------------------------------------------
def _cons_trigexp(x):
    xm, xk, xp = x[:-2], x[1:-1], x[2:]
    return (
        3.0 * xk**3
        + 2.0 * xp
        - 5.0
        + torch.sin(xk - xp) * torch.sin(xk + xp)
        + 4.0 * xk
        - xm * torch.exp(xm - xk)
        - 3.0
    )


def _cons_broyden_tridiag(x):
    xm, xk, xp = x[:-2], x[1:-1], x[2:]
    return (3.0 - 2.0 * xk) * xk - xm - 2.0 * xp + 1.0


def _cons_broyden_banded(x):
    # c_k = (2+5x_k^2)x_k + 1 + sum_{i in J_k} x_i(1+x_i),
    # J_k = {max(1,k-lo)..min(n,k+hi)} \ {k}; interior rows only (p = n-2).
    # The window sums are differences of one cumulative sum, gathered at
    # index tensors (no loop over n).
    lo, hi = 5, 1
    n = x.shape[0]
    y = x * (1.0 + x)
    csum = torch.cumsum(y, 0)
    ks = torch.arange(1, n - 1, device=x.device)
    loi = (ks - lo).clamp(0, n - 1)
    hii = (ks + hi).clamp(0, n - 1)
    below = torch.where(loi > 0, csum[(loi - 1).clamp(min=0)], torch.zeros_like(csum[loi]))
    s = csum[hii] - below - y[ks]
    return (2.0 + 5.0 * x[ks] ** 2) * x[ks] + 1.0 + s


# ----------------------------------------------------------------------
# assembled problems
# ----------------------------------------------------------------------
def _even(n: int) -> int:
    n = max(int(n), 6)
    return n if n % 2 == 0 else n + 1


def _make(name, res_fn, cons_fn, x0, n, dtype, device) -> NLSProblem:
    x0 = torch.as_tensor(x0, dtype=dtype or torch.float64, device=default_device(device))
    m = int(res_fn(x0).shape[0])
    p = n - 2
    return nls_problem(
        res_fn, x0, m, cons_fn, np.zeros(p), np.zeros(p), name=f"{name}_{n}", device=x0.device,
    )


def lvcon_rosenbrock_trigexp(n: int = 10, *, dtype=None, device=None) -> NLSProblem:
    """Chained Rosenbrock objective, trigonometric-exponential constraints
    (LV TR-767 class 5.1)."""
    n = max(int(n), 4)
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    return _make("lvcon_rosenbrock_trigexp", _res_chained_rosenbrock, _cons_trigexp, x0, n,
                 dtype, device)


def lvcon_wood_broyden(n: int = 12, *, dtype=None, device=None) -> NLSProblem:
    """Chained Wood objective, Broyden-tridiagonal constraints
    (LV TR-767 class 5.2)."""
    n = _even(n)
    x0 = np.where(np.arange(n) % 2 == 0, -3.0, -1.0)
    return _make("lvcon_wood_broyden", _res_chained_wood, _cons_broyden_tridiag, x0, n,
                 dtype, device)


def lvcon_powell_banded(n: int = 12, *, dtype=None, device=None) -> NLSProblem:
    """Chained Powell-singular objective, Broyden-banded constraints
    (LV TR-767 class 5.3)."""
    n = _even(n)
    x0 = np.full(n, 0.5)  # the banded system is mildly nonlinear; start near 0
    x0[::2] = -0.5
    return _make("lvcon_powell_banded", _res_chained_powell, _cons_broyden_banded, x0, n,
                 dtype, device)


def lvcon_exponential_tridiag(n: int = 10, *, dtype=None, device=None) -> NLSProblem:
    """Chained exponential objective, Broyden-tridiagonal constraints
    (LV TR-767 class 5.4 flavor)."""
    n = max(int(n), 4)
    # x0 = 0 puts the first extrapolation step outside exp()'s range
    x0 = np.full(n, 0.5)
    return _make("lvcon_exponential_tridiag", _res_chained_exponential, _cons_broyden_tridiag,
                 x0, n, dtype, device)


def lvcon_rosenbrock_tridiag(n: int = 10, *, dtype=None, device=None) -> NLSProblem:
    """Chained Rosenbrock objective, Broyden-tridiagonal constraints
    (LV TR-767 class 5.5 flavor)."""
    n = max(int(n), 4)
    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    return _make("lvcon_rosenbrock_tridiag", _res_chained_rosenbrock, _cons_broyden_tridiag,
                 x0, n, dtype, device)


_SUITE: List[LVConSpec] = [
    LVConSpec("lvcon_rosenbrock_trigexp", lvcon_rosenbrock_trigexp, 10),
    LVConSpec("lvcon_wood_broyden", lvcon_wood_broyden, 12),
    LVConSpec("lvcon_powell_banded", lvcon_powell_banded, 12),
    LVConSpec("lvcon_exponential_tridiag", lvcon_exponential_tridiag, 10),
    LVConSpec("lvcon_rosenbrock_tridiag", lvcon_rosenbrock_tridiag, 10),
]

LVCON_NAMES = [s.name for s in _SUITE]


def lvcon_problem(name: str, n: int = 0, *, dtype=None, device=None) -> NLSProblem:
    for s in _SUITE:
        if s.name == name:
            return s.build(n or s.default_n, dtype=dtype, device=device)
    raise KeyError(f"unknown LVcon problem {name!r}; have {LVCON_NAMES}")


def lvcon_suite(n: int = 0, *, dtype=None, device=None) -> List[NLSProblem]:
    return [s.build(n or s.default_n, dtype=dtype, device=device) for s in _SUITE]
