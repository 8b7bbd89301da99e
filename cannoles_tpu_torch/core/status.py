"""Solver status codes and execution stats.

PyTorch counterpart of ``cannoles_tpu/core/status.py``.  The status is an
int32 tensor with a leading batch axis carried in the solver state, decoded
to a name on the host.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict

import torch

__all__ = ["Status", "ExecutionStats", "status_name", "get_status_code", "MSG"]


class Status(enum.IntEnum):
    UNKNOWN = 0
    FIRST_ORDER = 1
    SMALL_RESIDUAL = 2
    STALLED = 3
    MAX_ITER = 4
    MAX_EVAL = 5
    MAX_TIME = 6
    EXCEPTION = 7
    USER = 8


_NAMES = {s: s.name.lower() for s in Status}


def status_name(code: int) -> str:
    return _NAMES[Status(int(code))]


# internal_msg codes (reference line-search and Newton-step errors)
MSG = {
    0: "",
    1: "ρ → ∞",
    2: "Failure in Newton step computation",
    3: "d → ∞ or NaN",
    4: "f → ∞",
    5: "Dϕ ≥ 0 (not a descent direction)",
    6: "α too small",
}


def get_status_code(
    *,
    optimal,
    small_residual,
    broken,
    evals,
    max_eval,
    iter_=None,
    max_iter=None,
    stalled=None,
):
    """Batched branch-free status resolution; later writes = higher priority:
    optimal > small_residual > stalled > max_iter > max_eval > exception.
    max_time and user are decided on the host by ``solve()``."""
    status = torch.zeros(broken.shape, dtype=torch.int32, device=broken.device)

    def put(cond, code):
        return torch.where(cond, torch.full_like(status, int(code)), status)

    status = put(broken, Status.EXCEPTION)
    status = put(evals > max_eval, Status.MAX_EVAL)
    if iter_ is not None and max_iter is not None:
        status = put((max_iter >= 0) & (iter_ > max_iter), Status.MAX_ITER)
    if stalled is not None:
        status = put(stalled, Status.STALLED)
    status = put(small_residual, Status.SMALL_RESIDUAL)
    status = put(optimal, Status.FIRST_ORDER)
    return status


@dataclasses.dataclass
class ExecutionStats:
    """Host-side result object (GenericExecutionStats analog).

    Mutable so the user callback can flip ``status`` to ``'user'`` to stop
    the run."""

    status: str = "unknown"
    solution: Any = None
    objective: float = float("nan")
    dual_feas: float = float("nan")
    primal_feas: float = float("nan")
    multipliers: Any = None
    iter: int = 0
    elapsed_time: float = 0.0
    solver_specific: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def status_reliable(self) -> bool:
        return True

    @property
    def solution_reliable(self) -> bool:
        return self.solution is not None

    @property
    def objective_reliable(self) -> bool:
        return self.objective == self.objective

    def __repr__(self):
        return (
            f"ExecutionStats(status={self.status!r}, objective={self.objective:.6g}, "
            f"dual_feas={self.dual_feas:.3g}, primal_feas={self.primal_feas:.3g}, "
            f"iter={self.iter}, time={self.elapsed_time:.3g}s)"
        )
