"""Algorithm hyper-parameters, precision-derived.

PyTorch counterpart of ``cannoles_tpu/params.py``: every constant is derived
from the machine epsilon of the working dtype (``torch.finfo``), so the same
algorithm runs in float64 (parity runs), float32 (GPU throughput) and float16.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Params", "MAX_DLAMBDA", "F_BLOWUP", "SMAX"]


@dataclasses.dataclass(frozen=True)
class Params:
    """Regularization / line-search constants (reference: ParamCaNNOLeS).

      eig_tol   = eps            (pivot/eigenvalue zero tolerance)
      delta_min = sqrt(eps)      (floor for the dual regularizer delta)
      kappa_dec = 1/3            (rho shrink factor relative to last good rho)
      kappa_inc = 8              (rho escalation when a previous rho existed)
      kappa_large_inc = min(100, 16*sizeof(T))  (first-time rho escalation)
      rho0      = eps^(1/3)      (first regularization attempt)
      rho_max   = eps^(-2)       (give-up threshold, capped below dtype max)
      rho_min   = sqrt(eps)      (floor for rho)
      gamma_A   = eps^(1/4)      (Armijo slope fraction)
    """

    eig_tol: float
    delta_min: float
    kappa_dec: float
    kappa_inc: float
    kappa_large_inc: float
    rho0: float
    rho_max: float
    rho_min: float
    gamma_A: float

    @staticmethod
    def for_dtype(dtype: torch.dtype, **overrides) -> "Params":
        fi = torch.finfo(dtype)
        eps = float(fi.eps)
        itemsize = fi.bits // 8
        vals = dict(
            eig_tol=eps,
            delta_min=math.sqrt(eps),
            kappa_dec=1.0 / 3.0,
            kappa_inc=8.0,
            kappa_large_inc=float(min(100, 16 * itemsize)),
            rho0=float(eps ** (1.0 / 3.0)),
            rho_max=float(min(eps ** (-2.0), float(fi.max) * (1 - 2 * eps))),
            rho_min=math.sqrt(eps),
            gamma_A=float(eps**0.25),
        )
        vals.update(overrides)
        return Params(**vals)


# Extrapolation step-length clip on the multiplier step (reference Mdlambda).
MAX_DLAMBDA = 1e4

# Objective blow-up guard (reference F_BLOWUP).
F_BLOWUP = 1e60

# Dual-feasibility scaling cap (reference smax).
SMAX = 100.0
