"""Basic problem fixtures mirroring the reference test battery.

Port of ``cannoles_tpu/models/basic.py``.  Every builder takes
``dtype=None`` (float64) and ``device=None`` (the card; ``"cpu"`` builds on
the CPU, and without a card ``None`` raises).  :func:`constrained` follows
its base problem's dtype and device."""

from __future__ import annotations

import numpy as np
import torch

from ..problem import NLSProblem, nls_problem

__all__ = [
    "readme_example",
    "mgh01",
    "mgh01con",
    "mgh01_nofhess",
    "hs6",
    "linear_nls",
    "rosenbrock_nls",
    "chained_rosenbrock",
    "underdetermined",
    "constrained",
]


def readme_example(n: int = 3, *, dtype=None, device=None) -> NLSProblem:
    """ADNLSModel(x -> x, ones(3), 3), the reference's doctest."""
    return nls_problem(lambda x: x, np.ones(n), n, name="readme", dtype=dtype, device=device)


def rosenbrock_nls(x0=(-1.2, 1.0), *, dtype=None, device=None) -> NLSProblem:
    return nls_problem(
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        np.asarray(x0, dtype=float),
        2,
        name="MGH01",
        dtype=dtype,
        device=device,
    )


mgh01 = rosenbrock_nls


def mgh01con(*, dtype=None, device=None) -> NLSProblem:
    """Constrained Rosenbrock: F = [1-x1; 10(x2-x1²)], c: x1 = 0.5."""
    return nls_problem(
        lambda x: torch.stack([1 - x[0], 10 * (x[1] - x[0] ** 2)]),
        [-1.2, 1.0],
        2,
        lambda x: torch.stack([x[0] - 0.5]),
        [0.0],
        [0.0],
        name="MGH01CON",
        dtype=dtype,
        device=device,
    )


def mgh01_nofhess(*, dtype=None, device=None) -> NLSProblem:
    """Rosenbrock declaring no residual-Hessian capability."""
    return nls_problem(
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        [-1.2, 1.0],
        2,
        has_residual_hessian=False,
        name="MGH01_noFHess",
        dtype=dtype,
        device=device,
    )


def hs6(x0=(-1.2, 1.0), *, dtype=None, device=None) -> NLSProblem:
    """HS6: min ½(x1-1)² s.t. 10(x2-x1²)=0."""
    return nls_problem(
        lambda x: torch.stack([x[0] - 1]),
        np.asarray(x0, dtype=float),
        1,
        lambda x: torch.stack([10 * (x[1] - x[0] ** 2)]),
        [0.0],
        [0.0],
        name="HS6",
        dtype=dtype,
        device=device,
    )


def linear_nls(*, dtype=None, device=None) -> NLSProblem:
    return nls_problem(
        lambda x: torch.stack([x[0] - 2, x[1] - 3]), -np.ones(2), 2, name="linear",
        dtype=dtype, device=device,
    )


def chained_rosenbrock(n: int = 10, x0_scale: float = 0.9, *, dtype=None, device=None) -> NLSProblem:
    def F(x):
        return torch.cat([10 * (x[1:] - x[:-1] ** 2), x[:-1] - 1])

    return nls_problem(F, x0_scale * np.ones(n), 2 * (n - 1), name=f"chained_rosenbrock_{n}",
                       dtype=dtype, device=device)


def underdetermined(n: int = 10, level: float = 1.0, *, dtype=None, device=None) -> NLSProblem:
    def F(x):
        return x[0] - x[1:]

    return nls_problem(F, level * np.ones(n), n - 1, name=f"underdetermined_{n}",
                       dtype=dtype, device=device)


def constrained(base: NLSProblem, kind: str = "linear") -> NLSProblem:
    """Attach the reference's test constraints to an unconstrained fixture:
    'linear': sum(x)=1;  'quad': [sum(x²)-5; prod(x)-2].  The result keeps
    the base's residual, data, dtype and device."""
    if kind == "linear":
        def c(x):
            return torch.stack([x.sum() - 1])
        p = 1
    elif kind == "quad":
        def c(x):
            return torch.stack([(x**2).sum() - 5, x.prod() - 2])
        p = 2
    else:
        raise ValueError(kind)
    return nls_problem(
        lambda x, d: base.residual(x, d),
        base.x0,
        base.nequ,
        c,
        np.zeros(p),
        np.zeros(p),
        data=base.data,
        name=f"{base.name}+{kind}",
        dtype=base.x0.dtype,
        device=base.x0.device,
    )
