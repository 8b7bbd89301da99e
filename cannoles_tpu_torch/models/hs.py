"""Equality-constrained NLS battery: Hock–Schittkowski problems whose
objectives are sums of squares (the constrained counterpart of the MGH
suite).

Port of ``cannoles_tpu/models/hs.py``.  ``fstar`` records the certified
optimal Σfᵢ² (= HS objective) where known.  A spec's ``make`` takes
``dtype=None`` (float64) and ``device=None`` (the card; ``"cpu"`` builds on
the CPU).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..problem import NLSProblem, nls_problem

__all__ = ["hs_suite", "hs_problem", "HS_NAMES", "HSSpec"]

_SQ2 = float(np.sqrt(2.0))


class HSSpec(NamedTuple):
    name: str
    make: Callable[..., NLSProblem]  # make(dtype=None, device=None)
    fstar: Optional[float]  # certified min of Σ fᵢ²


def _p(F, x0, m, c, p, name, dtype, device) -> NLSProblem:
    return nls_problem(
        F, np.asarray(x0, dtype=float), m, c, np.zeros(p), np.zeros(p), name=name,
        dtype=dtype, device=device,
    )


def hs6(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([1 - x[0]]),
        [-1.2, 1.0], 1,
        lambda x: torch.stack([10 * (x[1] - x[0] ** 2)]), 1, "hs6", dtype, device,
    )


def hs26(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - x[1], (x[1] - x[2]) ** 2]),
        [-2.6, 2.0, 2.0], 2,
        lambda x: torch.stack([(1 + x[1] ** 2) * x[0] + x[2] ** 4 - 3]), 1, "hs26", dtype, device,
    )


def hs27(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([(x[0] - 1) / 10.0, x[1] - x[0] ** 2]),
        [2.0, 2.0, 2.0], 2,
        lambda x: torch.stack([x[0] + x[2] ** 2 + 1]), 1, "hs27", dtype, device,
    )


def hs28(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] + x[1], x[1] + x[2]]),
        [-4.0, 1.0, 1.0], 2,
        lambda x: torch.stack([x[0] + 2 * x[1] + 3 * x[2] - 1]), 1, "hs28", dtype, device,
    )


def hs42(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - 1, x[1] - 2, x[2] - 3, x[3] - 4]),
        [1.0, 1.0, 1.0, 1.0], 4,
        lambda x: torch.stack([x[0] - 2, x[2] ** 2 + x[3] ** 2 - 2]), 2, "hs42", dtype, device,
    )


def hs46(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - x[1], x[2] - 1, (x[3] - 1) ** 2, (x[4] - 1) ** 3]),
        [_SQ2 / 2, 1.75, 0.5, 2.0, 2.0], 4,
        lambda x: torch.stack(
            [x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1,
             x[1] + x[2] ** 4 * x[3] ** 2 - 2]
        ), 2, "hs46", dtype, device,
    )


def hs48(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - 1, x[1] - x[2], x[3] - x[4]]),
        [3.0, 5.0, -3.0, 2.0, -2.0], 3,
        lambda x: torch.stack([x.sum() - 5, x[2] - 2 * (x[3] + x[4]) - 3]), 2, "hs48", dtype, device,
    )


def hs49(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - x[1], x[2] - 1, (x[3] - 1) ** 2, (x[4] - 1) ** 3]),
        [10.0, 7.0, 2.0, -3.0, 0.8], 4,
        lambda x: torch.stack([x[0] + x[1] + x[2] + 4 * x[3] - 7, x[2] + 5 * x[4] - 6]),
        2, "hs49", dtype, device,
    )


def hs50(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - x[1], x[1] - x[2], (x[2] - x[3]) ** 2, x[3] - x[4]]),
        [35.0, -31.0, 11.0, 5.0, -5.0], 4,
        lambda x: torch.stack(
            [x[0] + 2 * x[1] + 3 * x[2] - 6,
             x[1] + 2 * x[2] + 3 * x[3] - 6,
             x[2] + 2 * x[3] + 3 * x[4] - 6]
        ), 3, "hs50", dtype, device,
    )


def hs51(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - x[1], x[1] + x[2] - 2, x[3] - 1, x[4] - 1]),
        [2.5, 0.5, 2.0, -1.0, 0.5], 4,
        lambda x: torch.stack([x[0] + 3 * x[1] - 4, x[2] + x[3] - 2 * x[4], x[1] - x[4]]),
        3, "hs51", dtype, device,
    )


def hs52(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([4 * x[0] - x[1], x[1] + x[2] - 2, x[3] - 1, x[4] - 1]),
        [2.0, 2.0, 2.0, 2.0, 2.0], 4,
        lambda x: torch.stack([x[0] + 3 * x[1], x[2] + x[3] - 2 * x[4], x[1] - x[4]]),
        3, "hs52", dtype, device,
    )


def hs53(*, dtype=None, device=None):
    # HS53's ±10 box bounds are inactive at x* = (-33, 11, 27, -5, 11)/43
    # and are dropped (the reference rejects bounds outright)
    return _p(
        lambda x: torch.stack([x[0] - x[1], x[1] + x[2] - 2, x[3] - 1, x[4] - 1]),
        [2.0] * 5, 4,
        lambda x: torch.stack([x[0] + 3 * x[1], x[2] + x[3] - 2 * x[4], x[1] - x[4]]),
        3, "hs53", dtype, device,
    )


def hs60(*, dtype=None, device=None):
    # (x1-1)^2 + (x1-x2)^2 + (x2-x3)^4 with one nonlinear equality; the ±10
    # bounds are inactive at x* ≈ (1.1049, 1.1967, 1.5353) and dropped
    return _p(
        lambda x: torch.stack([x[0] - 1, x[0] - x[1], (x[1] - x[2]) ** 2]),
        [2.0, 2.0, 2.0], 3,
        lambda x: torch.stack([x[0] * (1 + x[1] ** 2) + x[2] ** 4 - 4 - 3 * _SQ2]),
        1, "hs60", dtype, device,
    )


def hs61(*, dtype=None, device=None):
    # the quadratic 4x1²+2x2²+2x3²−33x1+16x2−24x3 as the completed square
    # ‖F‖² − 172.0625: same minimizer; fstar records the Σf² value
    return _p(
        lambda x: torch.stack([2 * (x[0] - 33 / 8), _SQ2 * (x[1] + 4), _SQ2 * (x[2] - 6)]),
        [0.0, 0.0, 0.0], 3,
        lambda x: torch.stack([3 * x[0] - 2 * x[1] ** 2 - 7, 4 * x[0] - x[2] ** 2 - 11]),
        2, "hs61", dtype, device,
    )


def hs77(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack([x[0] - 1, x[0] - x[1], x[2] - 1, (x[3] - 1) ** 2, (x[4] - 1) ** 3]),
        [2.0] * 5, 5,
        lambda x: torch.stack(
            [x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 2 * _SQ2,
             x[1] + x[2] ** 4 * x[3] ** 2 - 8 - _SQ2]
        ), 2, "hs77", dtype, device,
    )


def hs79(*, dtype=None, device=None):
    return _p(
        lambda x: torch.stack(
            [x[0] - 1, x[0] - x[1], x[1] - x[2], (x[2] - x[3]) ** 2, (x[3] - x[4]) ** 2]
        ),
        [2.0] * 5, 5,
        lambda x: torch.stack(
            [x[0] + x[1] ** 2 + x[2] ** 3 - 2 - 3 * _SQ2,
             x[1] - x[2] ** 2 + x[3] + 2 - 2 * _SQ2,
             x[0] * x[4] - 2]
        ), 3, "hs79", dtype, device,
    )


_SUITE: List[HSSpec] = [
    HSSpec("hs6", hs6, 0.0),
    HSSpec("hs26", hs26, 0.0),
    HSSpec("hs27", hs27, 0.04),
    HSSpec("hs28", hs28, 0.0),
    HSSpec("hs42", hs42, 13.8578643763),  # 28 - 10*sqrt(2)
    HSSpec("hs46", hs46, 0.0),
    HSSpec("hs48", hs48, 0.0),
    HSSpec("hs49", hs49, 0.0),
    HSSpec("hs50", hs50, 0.0),
    HSSpec("hs51", hs51, 0.0),
    HSSpec("hs52", hs52, 5.32664756),  # 1859/349
    HSSpec("hs53", hs53, 4.09302326),  # 176/43
    HSSpec("hs60", hs60, 0.0325682003),
    HSSpec("hs61", hs61, 28.4163578),  # −143.6461422 + 172.0625
    HSSpec("hs77", hs77, 0.24150513),
    HSSpec("hs79", hs79, 0.0787768209),
]

HS_NAMES = [s.name for s in _SUITE]
_BY_NAME: Dict[str, HSSpec] = {s.name: s for s in _SUITE}


def hs_problem(name: str, *, dtype=None, device=None) -> NLSProblem:
    return _BY_NAME[name].make(dtype=dtype, device=device)


def hs_suite() -> List[HSSpec]:
    return list(_SUITE)
