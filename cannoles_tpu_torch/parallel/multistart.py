"""Batched multistart: turn instance-batch throughput into solve quality.

Port of ``cannoles_tpu/parallel/multistart.py``.  One batched solve sweeps
many perturbed starts of one problem and returns the best feasible
first-order point, where a single start may stop at a local minimum
(Freudenstein–Roth, Wood, penalty, ...).  The starts come from the same
numpy generator as in the JAX package, so both packages draw the same
starts for a seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.solver import CaNNOLeSSolver
from ..core.status import ExecutionStats, status_name
from ..problem import NLSProblem
from .batch import BatchResult

__all__ = ["multistart"]


def _expand(tree, B):
    """The problem's unbatched data with a leading batch axis of B (a view
    of each leaf, no copy), as the batch-native solver takes it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _expand(v, B) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_expand(v, B) for v in tree)
    return tree.expand((B,) + tuple(tree.shape))


def multistart(
    problem: NLSProblem,
    n_starts: int = 64,
    scale: float = 1.0,
    *,
    solver: Optional[CaNNOLeSSolver] = None,
    method: str = "newton",
    linsolve: str = "ldlt",
    kkt: str = "full",
    seed: int = 0,
    max_iter: int = 100,
    include_x0: bool = True,
    **numeric,
) -> ExecutionStats:
    """Solve from ``n_starts`` perturbed initial points in one batch; return
    stats at the best (lowest-objective, feasible, solved) lane.

    Perturbations are Gaussian with per-coordinate width
    ``scale * max(1, |x0|)`` around ``problem.x0`` (lane 0 keeps x0 itself
    when ``include_x0``).  The batch runs on the solver's device (by
    default the problem's).
    """
    problem.validate_for_solve()
    if solver is None:
        solver = CaNNOLeSSolver(problem, method=method, linsolve=linsolve, kkt=kkt)
    rng = np.random.default_rng(seed)
    x0 = problem.x0.cpu().numpy().astype(float)
    width = scale * np.maximum(1.0, np.abs(x0))
    starts = x0[None, :] + rng.normal(size=(n_starts, x0.shape[0])) * width[None, :]
    if include_x0:
        starts[0] = x0
    dev, dt = solver.device, solver.dtype
    x0s = torch.as_tensor(starts, dtype=dt, device=dev)
    lam0s = problem.y0.to(dtype=dt, device=dev).expand(n_starts, problem.ncon)
    cfg = solver.make_config(max_iter=max_iter, **numeric)
    states = solver.run(x0s, lam0s, cfg, _expand(problem.data, n_starts))
    res = BatchResult(states=states)

    solved = res.solved_mask()
    obj = res.objective.astype(float)
    cx = states.cx.cpu().numpy()
    # feasibility guard for constrained problems
    if problem.ncon > 0:
        feas = np.linalg.norm(cx, axis=1) <= np.sqrt(states.epstol.cpu().numpy())
        solved = solved & feas
    score = np.where(solved, obj, np.inf)
    best = int(np.argmin(score))

    stats = ExecutionStats()
    if not solved.any():
        # no lane solved: report the best-dual lane's status
        best = int(np.argmin(res.dual_feas))
    stats.status = status_name(int(res.status[best]))
    stats.solution = res.solution[best]
    stats.multipliers = res.multipliers[best]
    stats.objective = float(obj[best])
    stats.dual_feas = float(res.dual_feas[best])
    stats.primal_feas = float(np.linalg.norm(cx[best]))
    stats.iter = int(res.iterations[best])
    stats.solver_specific.update(
        n_starts=n_starts,
        n_solved=int(solved.sum()),
        best_lane=best,
        objectives=np.sort(obj[solved])[:8].tolist() if solved.any() else [],
    )
    return stats
